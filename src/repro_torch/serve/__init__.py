"""Serving steps: batched prefill and single-token decode."""
