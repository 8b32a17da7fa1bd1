"""DPM-Solver++(2M) for the inpainting sampler: the noise schedule and
the per-step coefficient tables, in numpy (port of
:mod:`inklayer_tpu.models.diffusion.scheduler` and
``pipeline._solver_tables``, which import jax).

Configured like diffusers' ``DPMSolverMultistepScheduler`` for SD1.5:
1000 train steps, scaled_linear betas 0.00085 -> 0.012, epsilon
prediction, solver order 2, lower-order final step.  The sampler applies
the whole update from the tables (the JAX package's stepwise ``step`` is
its reference, not a path of the pipeline), computed in float64 and
stored as float32, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


class DPMSolverMultistepScheduler:
    """The noise schedule: alpha_t, sigma_t and lambda_t = log(alpha_t /
    sigma_t) of the 1000 train timesteps (float64)."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
        self.num_train_timesteps = num_train_timesteps
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2  # scaled_linear
        alphas_cumprod = np.cumprod(1.0 - betas)
        self.alpha_t = np.sqrt(alphas_cumprod)
        self.sigma_t = np.sqrt(1 - alphas_cumprod)
        self.lambda_t = np.log(self.alpha_t) - np.log(self.sigma_t)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """linspace over the trained timesteps, descending."""
        return np.linspace(
            0, self.num_train_timesteps - 1, num_inference_steps + 1
        ).round()[::-1][:-1].astype(np.int64)


def solver_tables(sched: DPMSolverMultistepScheduler, steps: int):
    """DPM-Solver++(2M) per-step coefficients: (timesteps int32, alpha_t,
    sigma_t, c_sample, c_x0, c_d) float32 arrays of length ``steps``, so
    that one step is ``c_sample * x + c_x0 * x0 + c_d * (x0 - x0_prev)``
    with ``x0 = (x - sigma_t * eps) / alpha_t``."""
    ts = sched.timesteps(steps)
    n = len(ts)
    lam = sched.lambda_t[ts]
    nxt = np.append(ts[1:], 0)  # the final step lands on t = 0
    h = sched.lambda_t[nxt] - lam
    c_sample = sched.sigma_t[nxt] / sched.sigma_t[ts]
    c_x0 = -sched.alpha_t[nxt] * np.expm1(-h)
    c_d = np.zeros(n)
    for i in range(1, n - 1):  # second order except the first and final
        r = (lam[i] - lam[i - 1]) / h[i]
        c_d[i] = c_x0[i] * (1.0 / (2.0 * r))
    return (ts.astype(np.int32), sched.alpha_t[ts].astype(np.float32),
            sched.sigma_t[ts].astype(np.float32),
            c_sample.astype(np.float32), c_x0.astype(np.float32),
            c_d.astype(np.float32))
