"""repro_torch.serve — KV cache, prefill/decode engine and CTRServer."""
from repro_torch.serve.engine import (CTRServer, make_multi_target_prefill_fn,
                                      make_prefill_fn)

__all__ = ["CTRServer", "make_prefill_fn", "make_multi_target_prefill_fn"]
