"""Host-side utilities of the port: evaluation metrics and the JSONL
step logger."""
