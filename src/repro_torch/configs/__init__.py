"""repro_torch.configs — model configurations of the port (dti-llama only,
in this slice)."""
