"""repro_torch.serve — KV cache, prefill/decode engine and CTRServer."""
