"""Host-side utilities of the port: evaluation metrics, the JSONL step
logger and event journal, the durable-write seam and designed-sleep
scaling."""
