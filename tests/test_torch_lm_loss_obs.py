"""The port's LM loss (``core/losses.py::lm_loss``) and tracing pieces
(``obs/clock.py::ManualClock``, ``obs/profile.py::available``,
``launch/obs_report.py``) against ``repro`` on the CPU.

``lm_loss`` and its gradients within 1e-5 of the reference's (fp32,
summation order), chunked and not, tied and untied, with and without a
valid mask; trace summaries equal the reference's on one document.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import lm_loss as j_lm_loss
from repro.launch.obs_report import summarize as j_summarize
from repro.models.transformer import ModelConfig as JConfig
from repro.obs.clock import ManualClock as JClock
from repro.obs.trace import SpanTracer as JTracer
from repro_torch.core.losses import lm_loss
from repro_torch.launch.obs_report import main as report_main
from repro_torch.launch.obs_report import summarize
from repro_torch.models.transformer import ModelConfig
from repro_torch.obs import profile
from repro_torch.obs.clock import ManualClock
from repro_torch.obs.trace import SpanTracer, validate_chrome_trace

TOL = 1e-5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("chunk", [0, 16, 24])
def test_lm_loss_and_grads_match(chunk, tied, masked):
    """chunk 16 divides the vocabulary of 64 (online logsumexp over four
    chunks), 24 does not (one pass, as in the reference)."""
    v, d = 64, 12
    r = np.random.default_rng(chunk + 2 * tied + masked)
    hidden = r.normal(size=(2, 7, d)).astype(np.float32)
    targets = r.integers(0, v, (2, 7)).astype(np.int32)
    valid = (r.random((2, 7)) < 0.6) if masked else None
    params = {"embed": r.normal(size=(v, d)).astype(np.float32)}
    if not tied:
        params["lm_head"] = {"w": r.normal(size=(d, v)).astype(np.float32)}
    jcfg = JConfig(vocab_size=v, d_model=d, tie_embeddings=tied,
                   logits_chunk=chunk)
    cfg = ModelConfig(vocab_size=v, d_model=d, tie_embeddings=tied,
                      logits_chunk=chunk)

    def j_fn(p, h):
        return j_lm_loss(p, jcfg, h, jnp.asarray(targets),
                         None if valid is None else jnp.asarray(valid))
    want, (jg_p, jg_h) = jax.value_and_grad(j_fn, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(hidden))
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).requires_grad_(True), params)
    th = torch.from_numpy(hidden).requires_grad_(True)
    got = lm_loss(tp, cfg, th, torch.from_numpy(targets),
                  None if valid is None else torch.from_numpy(valid))
    got.backward()
    assert abs(got.item() - float(want)) < TOL
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg_h), atol=TOL,
                               rtol=0)
    # an untied head leaves the embedding out: no gradient, jax's zeros
    grads = jax.tree_util.tree_map(
        lambda t: np.zeros(t.shape, np.float32) if t.grad is None
        else t.grad.numpy(), tp)
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jg_p)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0)


def test_logits_chunk_crosses_the_bridge():
    import dataclasses
    from repro_torch.bridge import config_from_jax
    jcfg = JConfig(vocab_size=64, logits_chunk=16)
    assert config_from_jax(dataclasses.asdict(jcfg)).logits_chunk == 16
    assert ModelConfig().logits_chunk == JConfig().logits_chunk == 0


def _spans(tracer, clock):
    with tracer.span("outer"):
        clock.advance(1.0)
        with tracer.span("inner", row=3) as sp:
            clock.advance(0.5)
            sp.set(bucket=16)
        tracer.instant("admit", rid=7)
        tracer.counter("pages", 12)
        clock.advance(0.25)
    with tracer.span("inner"):
        clock.advance(2.0)


def test_manual_clock_gives_exact_span_durations():
    clk = ManualClock(10.0)
    assert clk() == 10.0
    tr = SpanTracer(clock=clk)
    _spans(tr, clk)
    doc = tr.to_chrome_trace()
    assert validate_chrome_trace(doc) == []
    durs = [(e["name"], e["dur"]) for e in doc["traceEvents"]
            if e["ph"] == "X"]
    assert sorted(durs) == [("inner", 500000.0), ("inner", 2000000.0),
                            ("outer", 1750000.0)]


def test_summary_equals_reference():
    tc, jc = ManualClock(), JClock()
    tr, jt = SpanTracer(clock=tc), JTracer(clock=jc)
    _spans(tr, tc)
    _spans(jt, jc)
    doc, jdoc = tr.to_chrome_trace(), jt.to_chrome_trace()
    assert summarize(doc) == j_summarize(jdoc) == j_summarize(doc)
    s = summarize(doc)
    assert s["spans"]["inner"]["count"] == 2
    assert s["spans"]["inner"]["total_ms"] == 2500.0
    assert s["instants"] == {"admit": 1}
    assert s["counters_last"] == {"pages": 12}


def test_report_cli(tmp_path, capsys):
    clk = ManualClock()
    tr = SpanTracer(clock=clk)
    _spans(tr, clk)
    good = tmp_path / "trace.json"
    tr.save(str(good))
    out = tmp_path / "summary.json"
    assert report_main([str(good), "--json", str(out)]) == 0
    assert json.loads(out.read_text()) == summarize(json.loads(
        good.read_text()))
    assert "outer" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": "x",
                                                "ts": "soon", "dur": -1}]}))
    assert report_main([str(bad)]) != 0
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert report_main([str(empty)]) != 0
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    assert report_main([str(broken)]) != 0
    assert report_main([str(tmp_path / "missing.json")]) != 0
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.obs_report",
                        str(good)], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "outer" in r.stdout, r.stderr
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.obs_report",
                        str(bad)], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "schema" in r.stderr


def test_profiler_is_available():
    assert profile.available() is True
