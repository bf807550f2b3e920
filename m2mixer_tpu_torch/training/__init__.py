"""Training engine of the port: metrics, callbacks, the metrics.jsonl logger
and the trainer (``from .trainer import Trainer``)."""
