"""repro_torch.sparse — embedding tables and their plain lookups."""
