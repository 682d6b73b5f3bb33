"""The cells at a size a CPU test holds: the same harness code, with
``harness.Hook`` choosing the device, the sizes and the limits."""

CELLS = ("granite-train-zipf-8x2048", "qwen3moe-prefill-zipf-8k")

# every width cut, the layer kinds and their ratios kept
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=32, d_expert=32, num_experts=8, top_k=2,
             vocab_size=500)


def shrink(arch: dict, traffic: dict, dtype: str = "float32") -> None:
    """The cell at a size a CPU test holds (``harness.Hook.adjust``)."""
    arch.update(SMALL, dtype=dtype)
    kind = traffic["kind"]
    if kind == "train":
        traffic.update(batch=2, seq=32)
    else:
        traffic.update(shapes=[[4, 16], [2, 32], [1, 64]],
                       roofline_tokens=64, attention_shape=[2, 32],
                       sample_range=4, trace_units=2)


def args(cell: str, seed: int = 3000000019, trace: int = 0,
         seconds: float = 0.5) -> list:
    return ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
