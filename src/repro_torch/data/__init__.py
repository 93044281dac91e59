"""repro_torch.data — the synthetic CTR corpus and its tokenizer."""
