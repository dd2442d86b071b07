"""Training: AdamW, the loss and train step with the fault-tolerant loop,
the synthetic data stream, atomic checkpoints and gradient compression.
Counterpart of src/repro/training/."""
