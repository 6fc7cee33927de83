"""Training substrate of the port: AdamW, the train step, checkpoints and
the fault-tolerant driver, as ``src/repro/train/`` has them."""
