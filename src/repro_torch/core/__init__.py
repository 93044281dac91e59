"""repro_torch.core — DTI prompts, attention math and the CTR readout."""
