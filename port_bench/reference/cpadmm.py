"""Plain CPADMM (paper Alg. 3) over a partial circulant A = P C.

The benchmark's frozen reference: plain PyTorch from the paper's equations,
independent of the program.  It is handed the same raw inputs as the
program (the float32 first column of C, the row set, the float32
measurements) and works out every derived quantity itself: the spectrum of
C, B = (rho C^T C + sigma I)^{-1}, D = (P^T P + rho I)^{-1} and P^T y.

Scaled-dual iteration, tau1 = tau2 = tau:

    x  = B (rho C^T (v + mu) + sigma (z - nu))
    v  = D (P^T y + rho (C x - mu))
    z  = prox(x + nu, alpha / sigma)
    mu = mu + tau (v - C x);  nu = nu + tau (x - z)

The recovered signal is z.  The stopping rule is the tolerance driver's:
a signal is live while its age is under ``max_iters`` and it is younger
than ``min_iters`` or its last relative change ||z' - z|| / (||z|| + 1e-12)
is above ``tol``; a signal that stops is frozen.

``precision`` is "float64" (the reference) or "bfloat16" (the control: the
same steps in float32 with every array the iteration keeps, and the
measurements, rounded to bfloat16).  Imports torch only.
"""

from __future__ import annotations

import math

import torch

PRECISIONS = {"float64": (torch.float64, None), "bfloat16": (torch.float32, torch.bfloat16)}


def soft_threshold(x: torch.Tensor, g: float) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - g, min=0.0)


def nonneg_soft_threshold(x: torch.Tensor, g: float) -> torch.Tensor:
    return torch.clamp(x - g, min=0.0)


PRIORS = {"l1": soft_threshold, "nonneg-l1": nonneg_soft_threshold}


class Cpadmm:
    """CPADMM on a block of signals y (B, m) through one operator."""

    def __init__(self, col, omega, y, *, alpha, rho, sigma, tau=1.0, prior="l1",
                 precision="float64"):
        self.real, self.store = PRECISIONS[precision]
        self.prox = PRIORS[prior]
        self.alpha, self.rho, self.sigma, self.tau = float(alpha), float(rho), float(sigma), \
            float(tau)
        n = col.shape[-1]
        self.n = n
        self.spec = torch.fft.rfft(col.to(self.real))
        self.b = 1.0 / (self.rho * self.spec.abs() ** 2 + self.sigma)
        self.d = torch.full((n,), 1.0 / self.rho, dtype=self.real, device=col.device)
        self.d[omega] = 1.0 / (1.0 + self.rho)
        self.pty = torch.zeros(y.shape[:-1] + (n,), dtype=self.real, device=col.device)
        self.pty[..., omega] = self._round(y.to(self.real))

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.store is None else t.to(self.store).to(self.real)

    def _c(self, x):
        return torch.fft.irfft(self.spec * torch.fft.rfft(x), n=self.n)

    def _ct(self, x):
        return torch.fft.irfft(self.spec.conj() * torch.fft.rfft(x), n=self.n)

    def _b(self, x):
        return torch.fft.irfft(self.b * torch.fft.rfft(x), n=self.n)

    def init(self):
        zero = torch.zeros_like(self.pty)
        return (zero, zero, zero, zero)  # v, z, mu, nu

    def step(self, state):
        v, z, mu, nu = state
        x = self._b(self.rho * self._ct(v + mu) + self.sigma * (z - nu))
        cx = self._c(x)
        v = self.d * (self.pty + self.rho * (cx - mu))
        z = self.prox(x + nu, self.alpha / self.sigma)
        mu = mu + self.tau * (v - cx)
        nu = nu + self.tau * (x - z)
        return tuple(self._round(t) for t in (v, z, mu, nu))

    def run_fixed(self, iters: int) -> torch.Tensor:
        """z after ``iters`` steps of every signal."""
        s = self.init()
        for _ in range(iters):
            s = self.step(s)
        return s[1]

    @staticmethod
    def _change(z_new, z_old):
        return torch.linalg.vector_norm(z_new - z_old, dim=-1) / (
            torch.linalg.vector_norm(z_old, dim=-1) + 1e-12)

    def _masked(self, new, old, live):
        keep = live[:, None]
        return tuple(torch.where(keep, a, b) for a, b in zip(new, old))

    def run_until(self, tol, min_iters, max_iters):
        """The tolerance driver's own stopping: -> (z, iterations) per signal."""
        s = self.init()
        bsz = self.pty.shape[0]
        age = torch.zeros(bsz, dtype=torch.int64, device=self.pty.device)
        delta = torch.full((bsz,), math.inf, dtype=self.real, device=self.pty.device)
        while True:
            live = (age < max_iters) & ((age < min_iters) | (delta > tol))
            if not bool(live.any()):
                return s[1], age
            new = self.step(s)
            delta = torch.where(live, self._change(new[1], s[1]), delta)
            s = self._masked(new, s, live)
            age = age + live.long()

    def run_to_counts(self, counts, min_iters):
        """Each signal stepped exactly ``counts`` times, -> (z, the relative
        change of its last step, the smallest relative change over the steps
        that ended at an age in [min_iters, count)), all per signal."""
        s = self.init()
        bsz = self.pty.shape[0]
        dev = self.pty.device
        age = torch.zeros(bsz, dtype=torch.int64, device=dev)
        last = torch.full((bsz,), math.inf, dtype=self.real, device=dev)
        least = torch.full((bsz,), math.inf, dtype=self.real, device=dev)
        for _ in range(int(counts.max())):
            live = age < counts
            new = self.step(s)
            d = self._change(new[1], s[1])
            s = self._masked(new, s, live)
            age = age + live.long()
            # a step that brought age to a < count, with a >= min_iters, left
            # the signal live only if its change was above tol
            before = live & (age < counts) & (age >= min_iters)
            least = torch.where(before, torch.minimum(least, d), least)
            last = torch.where(live & (age == counts), d, last)
        return s[1], last, least
