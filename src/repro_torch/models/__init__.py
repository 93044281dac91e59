"""repro_torch.models — layers, GQA attention, the decoder and the recsys
models (DIN, MIND, SASRec, xDeepFM)."""
