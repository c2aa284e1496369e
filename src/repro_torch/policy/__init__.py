"""Learned idle-timeout policy trained through the differentiable simulator
(port of ``repro.policy``).

The paper's crossover rule is optimal for stationary arrivals and the
ski-rental break-even timeout is 2-competitive against any adversary — but
on *regime-switching* traffic (flash crowds, bursty MMPP, diurnal cycles)
both leave energy on the table.  This package trains a small MLP over the
controller's own online features (EWMA rate, CV/burstiness, fast/slow
regime posterior) to emit a continuous idle timeout, using (a) backprop
through the smooth closed-form energy relaxations and (b) antithetic
evolution strategies over batched hard rollouts — a population of networks
over a batch of streams, on the card.

**Stationary-limit equivalence** — the wrapper's guard reproduces the
analytical :meth:`~repro_torch.core.adaptive.AdaptiveStrategy.decide` rule
exactly whenever the observed stream is stationary; an untrained network
is the ski-rental hybrid by construction (zero-initialised output layer):

>>> import math
>>> from repro_torch.core.adaptive import AdaptiveStrategy
>>> from repro_torch.core.phases import paper_lstm_item
>>> from repro_torch.core.strategies import IdlePowerMethod
>>> from repro_torch.policy import LearnedTimeoutPolicy, untrained_policy
>>> item = paper_lstm_item()
>>> trained = untrained_policy(item, method=IdlePowerMethod.METHOD1_2)
>>> pol = LearnedTimeoutPolicy(trained, item=item,
...                            prior_period_ms=40.0)   # below the crossover
>>> pol.idle_timeout_ms()                              # Idle-Waiting: never release
inf
>>> ref = AdaptiveStrategy(item=item, method=IdlePowerMethod.METHOD1_2)
>>> ref.decide(40.0), pol.regime()
('idle_waiting', 'idle_waiting')
>>> slow = LearnedTimeoutPolicy(trained, item=item, prior_period_ms=5000.0)
>>> slow.idle_timeout_ms()                             # On-Off: release now
0.0
>>> ref.decide(5000.0), slow.regime()
('on_off', 'on_off')
>>> pol.network_timeout_ms() == pol.break_even_ms()    # untrained == ski-rental
True
"""
from repro_torch.policy.controller import LearnedTimeoutPolicy
from repro_torch.policy.features import (
    FeatureState,
    N_FEATURES,
    feature_vector,
    feature_vector_py,
    init_state,
    update_state,
    update_state_py,
)
from repro_torch.policy.net import apply_mlp, init_mlp, timeout_ms
from repro_torch.policy.rollout import make_consts, mean_energy_per_gap, rollout
from repro_torch.policy.train import (
    TrainSettings,
    TrainedPolicy,
    train_policy,
    training_processes,
    untrained_policy,
)

__all__ = [
    "LearnedTimeoutPolicy",
    "FeatureState",
    "N_FEATURES",
    "feature_vector",
    "feature_vector_py",
    "init_state",
    "update_state",
    "update_state_py",
    "apply_mlp",
    "init_mlp",
    "timeout_ms",
    "make_consts",
    "mean_energy_per_gap",
    "rollout",
    "TrainSettings",
    "TrainedPolicy",
    "train_policy",
    "training_processes",
    "untrained_policy",
]
