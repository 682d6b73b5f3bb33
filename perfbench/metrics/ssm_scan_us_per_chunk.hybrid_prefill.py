"""ssm_scan_us_per_chunk.hybrid_prefill: device us of the SSD (the
``ssm.scan`` stage: the chunked state-space-duality products and the
recurrence across chunks) a chunk, over ``repro_ssm_chunks_total`` in the
same traced slice."""

from perfbench import stages_hybrid


def read(run):
    return stages_hybrid.scan_us_per_chunk(run)
