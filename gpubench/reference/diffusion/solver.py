"""DPM-Solver++(2M) over SD1.5's scaled-linear schedule, in float64: 1000
train steps, betas from 0.00085 to 0.012 spaced linearly in their square
root, epsilon prediction, timesteps spaced linearly over the train steps
(diffusers' ``DPMSolverMultistepScheduler``, ``timestep_spacing
"linspace"``).

The update from step i's latent x and noise prediction eps:
x0 = (x - sigma_s eps) / alpha_s; first order at the first and the last
step, x' = (sigma_t / sigma_s) x - alpha_t (exp(-h) - 1) x0, and second
order in between, adding -alpha_t (exp(-h) - 1) / (2 r) (x0 - x0_prev),
with h = lambda_t - lambda_s, r = (lambda_s - lambda_prev) / h and lambda =
log(alpha / sigma).  The last step lands on train step 0.

Departures from the published scheduler, as the program runs it: the last
step is first order (diffusers lowers it only below 15 steps).
"""

from __future__ import annotations

import numpy as np


class Schedule:
    def __init__(self, steps: int, train_steps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            train_steps, dtype=np.float64) ** 2
        cum = np.cumprod(1.0 - betas)
        self.alpha = np.sqrt(cum)
        self.sigma = np.sqrt(1.0 - cum)
        self.lam = np.log(self.alpha) - np.log(self.sigma)
        self.timesteps = np.linspace(0, train_steps - 1, steps + 1) \
            .round()[::-1][:-1].astype(np.int64)

    def step(self, i: int, x, eps, x0_prev):
        """(x', x0) of step ``i`` from the latent ``x``, the noise
        prediction ``eps`` and the previous step's x0 (None at step 0);
        tensors or arrays, computed in their dtype."""
        n = len(self.timesteps)
        s = self.timesteps[i]
        t = self.timesteps[i + 1] if i + 1 < n else 0
        h = self.lam[t] - self.lam[s]
        x0 = (x - self.sigma[s] * eps) / self.alpha[s]
        c_x0 = -self.alpha[t] * np.expm1(-h)
        out = (self.sigma[t] / self.sigma[s]) * x + c_x0 * x0
        if 0 < i < n - 1:
            r = (self.lam[s] - self.lam[self.timesteps[i - 1]]) / h
            out = out + c_x0 / (2.0 * r) * (x0 - x0_prev)
        return out, x0

    def eps_weight(self, i: int) -> float:
        """The derivative of step ``i``'s result by its noise prediction:
        the update moves by ``eps_weight(i) * eps`` for ``eps``."""
        n = len(self.timesteps)
        s = self.timesteps[i]
        t = self.timesteps[i + 1] if i + 1 < n else 0
        h = self.lam[t] - self.lam[s]
        c = -self.alpha[t] * np.expm1(-h)
        if 0 < i < n - 1:
            r = (self.lam[s] - self.lam[self.timesteps[i - 1]]) / h
            c = c * (1.0 + 1.0 / (2.0 * r))
        return float(-c * self.sigma[s] / self.alpha[s])
