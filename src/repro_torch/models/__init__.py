"""repro_torch.models — layers, GQA attention and the decoder."""
