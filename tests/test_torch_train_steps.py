"""Three fp32 train steps of the port against the reference's eager
steps (``jax.disable_jit``) on the CPU, each from the same state, and two
planted optimizer faults that the comparison must catch."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.training import train_loop
from repro_torch.training.train_loop import TrainState, _microbatch_grads, make_train_step
from repro_torch.tree import paths
from test_torch_train import _carry, _jflat, _two_threads, jref  # noqa: F401 (fixtures)

EPS, B2 = 1e-8, 0.95           # AdamW's eps and b2 (both sides' defaults)
UPDATE_REL = 1e-6              # one update from equal gradients, relative to each leaf's largest entry


def _port_state(tree, step: int) -> TrainState:
    """The reference's eager state, carried into the port's ``TrainState``."""
    return TrainState(zoo.params_from_numpy(tree.params, device="cpu"),
                      AdamWState(step, zoo.params_from_numpy(tree.opt.m, device="cpu"),
                                 zoo.params_from_numpy(tree.opt.v, device="cpu")), None)


@pytest.fixture(scope="module")
def reference_steps(jref):
    """Three fp32 train steps of the reference on the reduced qwen3, eager
    (``jax.disable_jit``): for each, the state it starts from, its batch
    and rate, its gradients and loss, the state after it, and the
    compiled step's parameters from the same start."""
    jcfg, cfg, jp, _ = _carry(jref, "qwen3-1.7b")
    jfns = jref["loop"].make_train_step(jcfg, jref["perf"].PerfConfig())
    eager = jfns.init_state(jp)
    step_fn = jax.jit(jfns.train_step)
    stream = SyntheticLMStream(cfg.vocab_size, 2, 16, seed=4)
    seen = {}
    recorded = jref["loop"]._microbatch_grads

    def recording(*args):
        seen["out"] = recorded(*args)
        return seen["out"]

    steps = []
    for step in range(3):
        raw = batch_for_arch(cfg, stream.next_batch())
        lr = 1e-2 * (step + 1)
        start = jax.device_get(eager)
        jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
        compiled, _ = step_fn(eager, jbatch, jnp.float32(lr))
        with jax.disable_jit(), pytest.MonkeyPatch.context() as patch:
            patch.setattr(jref["loop"], "_microbatch_grads", recording)
            eager, jm = jfns.train_step(eager, jbatch, jnp.float32(lr))
        steps.append({
            "start": start, "raw": raw, "lr": lr, "loss": float(seen["out"][0]),
            "grads": _jflat(seen["out"][1]), "grad_norm": float(jm["grad_norm"]),
            "params": _jflat(eager.params), "m": _jflat(eager.opt.m), "v": _jflat(eager.opt.v),
            "compiled": _jflat(compiled.params),
        })
    return cfg, steps


def _step_mismatches(reference_steps, monkeypatch, optimizer=None) -> list:
    """The port's train step from each of the reference's starting states
    (carried over) against the reference's eager step → what differs
    beyond the limits.

    The port's own step: the loss within 1e-6 relative, the gradient norm
    within 1e-5 and every gradient leaf within 1e-4 of its largest entry.
    The port's step again, given the reference's eager gradients: the
    moments within ``UPDATE_REL`` of each leaf's largest entry, and the
    parameters there too where ``sqrt(v̂) ≥ 1e3·eps``.  AdamW divides by
    ``sqrt(v̂) + eps``, so where ``sqrt(v̂)`` is within 1e3·eps (a gradient
    of the size of its rounding) one rounding of the clip moves an element
    by a different part of ``lr``: there the parameters are held within
    twice the reference's own distance between its compiled and its eager
    step from the same state (C-ref-9)."""
    cfg, steps = reference_steps
    fns = make_train_step(cfg, PerfConfig(), optimizer)
    bad = []
    for step, ref in enumerate(steps):
        batch = {k: torch.from_numpy(v) for k, v in ref["raw"].items()}
        lr_t = torch.tensor(ref["lr"], dtype=torch.float32)

        grads = {}
        with monkeypatch.context() as patch:     # the port's own gradients, kept
            patch.setattr(train_loop, "_microbatch_grads",
                          lambda *a: grads.setdefault("out", _microbatch_grads(*a)))
            _, m = fns.train_step(_port_state(ref["start"], step), batch, lr_t)
        if abs(float(m["loss"]) - ref["loss"]) > 1e-6 * abs(ref["loss"]):
            bad.append((step, "loss", float(m["loss"]), ref["loss"]))
        if abs(float(m["grad_norm"]) - ref["grad_norm"]) > 1e-5 * ref["grad_norm"]:
            bad.append((step, "grad_norm", float(m["grad_norm"]), ref["grad_norm"]))
        for k, g in grads["out"][1].items():
            want = ref["grads"][k]
            if float(np.abs(g.numpy() - want).max()) > 1e-4 * float(np.abs(want).max()):
                bad.append((step, "gradient", k))

        with monkeypatch.context() as patch:     # the update, from the reference's gradients
            patch.setattr(train_loop, "_microbatch_grads", lambda *a: (
                torch.tensor(ref["loss"]), {k: torch.from_numpy(np.array(g)) for k, g in ref["grads"].items()}))
            state, _ = fns.train_step(_port_state(ref["start"], step), batch, lr_t)
        if state.opt.step != step + 1:
            bad.append((step, "opt.step", state.opt.step))
        decided = {k: np.sqrt(v / (1 - B2 ** (step + 1))) >= 1e3 * EPS for k, v in ref["v"].items()}
        ours = {"params": paths(state.params), "m": paths(state.opt.m), "v": paths(state.opt.v)}
        for tree, leaves in ours.items():
            assert leaves.keys() == ref[tree].keys()
            for k, t in leaves.items():
                want = ref[tree][k]
                scale = float(np.abs(want).max())
                err = np.abs(t.detach().numpy() - want) / scale
                mask = decided[k] if tree == "params" else np.ones(want.shape, bool)
                if mask.any() and err[mask].max() > UPDATE_REL:
                    bad.append((step, tree, k, "decided", float(err[mask].max())))
                if (~mask).any():
                    spread = float((np.abs(ref["compiled"][k] - want) / scale)[~mask].max())
                    if err[~mask].max() > max(UPDATE_REL, 2 * spread):
                        bad.append((step, tree, k, "near eps", float(err[~mask].max()), spread))
    return bad


def test_three_train_steps_equal_the_reference_run_op_by_op(reference_steps, monkeypatch):
    assert _step_mismatches(reference_steps, monkeypatch) == []


def _no_bias_correction():
    """AdamW with its bias correction skipped (a step count so large that
    1 − b^t rounds to 1)."""
    inner = adamw()
    return inner._replace(update=lambda g, s, p, lr: inner.update(g, s._replace(step=10 ** 6), p, lr))


@pytest.mark.parametrize("fault", ["weight decay dropped", "bias correction skipped"])
def test_three_train_steps_catch_a_planted_fault(reference_steps, monkeypatch, fault):
    optimizer = adamw(weight_decay=0.0) if fault == "weight decay dropped" else _no_bias_correction()
    bad = _step_mismatches(reference_steps, monkeypatch, optimizer)
    assert any(b[1] == "params" and b[3] == "decided" for b in bad), bad
