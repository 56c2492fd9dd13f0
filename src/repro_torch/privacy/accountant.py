"""RDP (moments) accountant for the (subsampled) Gaussian mechanism.

The port's own copy of ``src/repro/privacy/accountant.py`` (pure
``math``; the port imports nothing of the reference package), held to it
by tests/test_torch_privacy.py.

Every private release in this codebase is a Gaussian mechanism: the
client clips the sensitive quantity to L2 norm ``C`` (per-example
gradients during local training; rows of the uploaded
logits/activations) and adds ``N(0, (sigma * C)^2)`` noise, so each
release is (alpha, alpha / (2 sigma^2))-RDP at every order alpha and
releases compose additively in RDP.

**Subsampling amplification** (``sample_rate`` q < 1): the engines
report the per-step sampling rate q = batch_size / |local data| (worst
case over clients), and each release is accounted as a *sampled
Gaussian mechanism* with the standard integer-order upper bound
(Mironov, Talwar & Zhang 2019, "Rényi Differential Privacy of the
Sampled Gaussian Mechanism"):

    RDP(alpha) <= 1/(alpha-1) * log( sum_{k=0}^{alpha}
        C(alpha, k) (1-q)^(alpha-k) q^k exp((k^2 - k) / (2 sigma^2)) )

computed in log-space (the exp terms overflow for large alpha
otherwise) and restricted to the integer orders of the grid.  At q = 1
the sum collapses to the k = alpha term and the bound reduces exactly
to alpha / (2 sigma^2) — the full-participation composition the q = 1
path uses at every (fractional) order, which is the regime where the
RDP-of-Gaussian composition is tight.

Two approximations to flag when reading the amplified figure: the
batching model is shuffled full passes rather than Poisson sampling,
and the FedLLM/KD noise sits at the *upload boundary* (one release per
round over a model that saw every local example) rather than per
subsampled step — only Split's per-step c2 activation noise matches
the sampled-release model exactly.  The reported epsilon is therefore
the standard optimistic DP-SGD-style figure; ROADMAP records
per-framework-exact accounting as the open next step.

Conversion to (eps, delta) uses the classic bound

    eps = min_alpha [ T * RDP(alpha) + log(1/delta)/(alpha-1) ]

whose q = 1 analytic optimum ``T/(2 sigma^2) + sqrt(2 T log(1/delta))
/ sigma`` (attained at alpha* = 1 + sigma * sqrt(2 log(1/delta) / T))
is pinned by the reference's unit tests against the grid minimum; the
q < 1 bound against a literal re-computation of the MTZ sum.
"""
from __future__ import annotations

import math
from typing import Sequence

# Dense low orders (where the optimum lands for few steps / small
# sigma) plus a geometric tail for heavily-composed regimes.
DEFAULT_ORDERS: Sequence[float] = tuple(
    [1.0 + x / 10.0 for x in range(1, 100)]
    + list(range(11, 64))
    + [2 ** p for p in range(6, 10)])


def gaussian_rdp(order: float, noise_multiplier: float) -> float:
    """RDP of one full-participation Gaussian mechanism release at
    ``order`` (sigma in units of the clip norm): alpha / (2 sigma^2)."""
    if noise_multiplier <= 0.0:
        return math.inf
    return order / (2.0 * noise_multiplier ** 2)


def subsampled_gaussian_rdp(order: int, noise_multiplier: float,
                            sample_rate: float) -> float:
    """MTZ'19 integer-order upper bound on the RDP of one sampled
    Gaussian mechanism release (log-space; exact q=1 / q=0 limits)."""
    if noise_multiplier <= 0.0:
        return math.inf
    q = float(sample_rate)
    if q >= 1.0:
        return gaussian_rdp(order, noise_multiplier)
    if q <= 0.0:
        return 0.0
    a = int(order)
    if a < 2 or a != order:
        raise ValueError(
            f"the subsampled-Gaussian bound needs an integer order >= 2 "
            f"(got {order})")
    s2 = 2.0 * noise_multiplier ** 2
    logs = []
    for k in range(a + 1):
        log_binom = (math.lgamma(a + 1) - math.lgamma(k + 1)
                     - math.lgamma(a - k + 1))
        logs.append(log_binom + (a - k) * math.log1p(-q)
                    + (k * math.log(q) if k else 0.0)
                    + (k * k - k) / s2)
    m = max(logs)
    lse = m + math.log(sum(math.exp(x - m) for x in logs))
    return lse / (a - 1)


def rdp_to_eps(rdp: float, order: float, delta: float) -> float:
    """Classic RDP -> (eps, delta) conversion at one order."""
    if order <= 1.0:
        return math.inf
    return rdp + math.log(1.0 / delta) / (order - 1.0)


class GaussianAccountant:
    """Tracks (eps, delta) of ``steps`` composed (subsampled) Gaussian
    releases at sampling rate ``sample_rate`` (1.0 = every release
    covers the full local dataset — no amplification claimed)."""

    def __init__(self, noise_multiplier: float, delta: float = 1e-5,
                 orders: Sequence[float] = DEFAULT_ORDERS,
                 sample_rate: float = 1.0):
        if delta <= 0.0 or delta >= 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        if sample_rate <= 0.0 or sample_rate > 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate}")
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.orders = tuple(orders)
        self.sample_rate = float(sample_rate)
        if self.sample_rate < 1.0 and not any(
                float(a).is_integer() and a >= 2 for a in self.orders):
            raise ValueError(
                "sample_rate < 1 needs at least one integer order >= 2 "
                "in the grid (the subsampled-Gaussian bound only exists "
                f"there); got orders={self.orders}")

    def _usable_orders(self) -> Sequence[float]:
        """The subsampled bound only exists at integer orders >= 2; the
        full-participation path uses the whole (fractional) grid."""
        if self.sample_rate >= 1.0:
            return self.orders
        return tuple(a for a in self.orders
                     if float(a).is_integer() and a >= 2)

    def _rdp(self, order: float) -> float:
        if self.sample_rate >= 1.0:
            return gaussian_rdp(order, self.noise_multiplier)
        return subsampled_gaussian_rdp(int(order), self.noise_multiplier,
                                       self.sample_rate)

    def epsilon(self, steps: int) -> float:
        """eps after ``steps`` releases (min over the order grid)."""
        if steps <= 0:
            return 0.0
        if self.noise_multiplier <= 0.0:
            return math.inf
        return min(rdp_to_eps(steps * self._rdp(a), a, self.delta)
                   for a in self._usable_orders())

    def closed_form_epsilon(self, steps: int) -> float:
        """The analytic optimum of the q = 1 bound (test oracle; the
        grid minimum approaches it from above)."""
        if steps <= 0:
            return 0.0
        s2 = self.noise_multiplier ** 2
        ln = math.log(1.0 / self.delta)
        return steps / (2.0 * s2) + math.sqrt(2.0 * steps * ln) \
            / self.noise_multiplier
