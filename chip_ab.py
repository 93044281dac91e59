#!/usr/bin/env python3
"""Time the kernels' existing instances of two checkouts on one card.

    python3 chip_ab.py PARENT_TREE CHANGED_TREE

Each tree's own ``chip_smoke.py`` helpers and kernels (built from its
sources into its own ``build/``) time, in a process of their own, kernel
1 at dti-llama's prefill shape, kernel 4's GQA mode at its decode shape
and its MLA mode at minicpm3-4b's (bf16 and int8 at s=64, bf16 at s=16),
kernels 2 and 3 (each pass on its own) at dti-llama's and minicpm3-4b's
training shapes, and the Dqk-192 classes at deepseek-v2's shapes (kernel
1's ``windowed_attn_192`` at its prefill shape and, as
``windowed_attn_192_train``, at its training shape; ``windowed_attn_dq_192``
and ``windowed_attn_dkv_192`` at its training shape), the operands made
from the seeds ``chip_smoke.py`` uses. The trees run in
turns, parent, change, change, parent, so that a drift of the card shows
on both sides. Each line is ``AB <tree> <json>``: per kernel, ms a call by
``cuda_ms`` (as the ``kernels`` line times it) and by ``cuda_ms_queued``
(the launches queued behind a sleep: device time only). The card's name
and power limit come first. Needs one NVIDIA card; exits non-zero
without one.
"""
import json
import subprocess
import sys
from pathlib import Path


def run_tree(root: Path, label: str) -> None:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_mla)
    from repro_torch.kernels.windowed_attn import windowed_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    out = {}

    def both(name, fn):
        out[name] = (cs.cuda_ms(fn), cs.cuda_ms_queued(fn))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    o, kw = cs.real_windowed(gen)
    both("windowed_attn", lambda: windowed_attention(
        o["q"], o["k"], o["v"], return_lse=True, **kw))
    o, kw = cs.real_decode(gen)
    both("decode_attn", lambda: decode_attention(
        o["q"], o["k"], o["v"], o["pos_q"], o["pos_k"], **kw))
    gen.manual_seed(12)
    o, kw = cs.real_mla(gen)
    both("decode_attn_mla", lambda: decode_attention_mla(*cs.mla_args(o),
                                                         **kw))
    o, q8, kw = cs.real_mla_q8(gen)
    both("decode_attn_mla_q8", lambda: decode_attention_mla(
        *cs.mla_args(o, q8), **kw))
    gen.manual_seed(7)
    o, kw = cs.real_mla(gen, s=16)
    both("decode_attn_mla_s16", lambda: decode_attention_mla(
        *cs.mla_args(o), **kw))
    del o, kw
    gen.manual_seed(4)
    for tag, heads in (("", cs.LLAMA_HEADS), ("_mla", cs.MLA_HEADS)):
        calls, _ = cs._bwd_launches(*cs.train_windowed(gen, heads=heads))
        for name, fn in calls.items():
            both(name + tag, fn)
        del calls
    # the Dqk-192 classes at deepseek-v2's shapes: kernel 1 at its prefill
    # shape (phase 6's seed) and at its training shape, kernels 2 and 3 at
    # its training shape (phase 2i's seed)
    gen.manual_seed(19)
    o, kw = cs.real_windowed_192(gen)
    both("windowed_attn_192", lambda: windowed_attention(
        o["q"], o["k"], o["v"], return_lse=True, **kw))
    del o, kw
    gen.manual_seed(28)
    o, kw = cs.train_windowed(gen, heads=cs.DS_HEADS)
    both("windowed_attn_192_train", lambda: windowed_attention(
        o["q"], o["k"], o["v"], return_lse=True, **kw))
    del o, kw
    gen.manual_seed(28)
    calls, _ = cs._bwd_launches(*cs.train_windowed(gen, heads=cs.DS_HEADS))
    for name, fn in calls.items():
        both(name + "_192", fn)
    del calls
    print("AB", label, json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        run_tree(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {"parent": sys.argv[1], "change": sys.argv[2]}
    for label in ("parent", "change", "change", "parent"):
        rc = subprocess.run([sys.executable, __file__, "--tree",
                             trees[label], label]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
