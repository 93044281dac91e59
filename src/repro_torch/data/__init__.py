"""repro_torch.data — the synthetic CTR corpus and its tokenizer, serving
request streams, and the recsys batch generator."""
