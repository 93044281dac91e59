"""repro_torch.train — optimizer, train step, checkpoints, resilience."""
