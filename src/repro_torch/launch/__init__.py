"""repro_torch.launch — command-line entry points, the recsys serve and
retrieval steps, and smoke training."""
