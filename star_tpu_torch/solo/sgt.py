"""Simple Good-Turing smoothing.

Numerically faithful port of the estimator used for the EmptyDrops_CR ambient
profile (reference: source/SimpleGoodTuring/sgt.h, Sampson & Gale with the
2000 bug fix): same accumulation order so doubles match bit-for-bit.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple


class SGT:
    def __init__(self):
        self.data: Dict[int, int] = {}  # obs -> freq (ordered by key at analyse)
        self.p_zero = 0.0
        self.estimates: Dict[int, float] = {}

    def add(self, observation: int, frequency: int):
        self.data[observation] = self.data.get(observation, 0) + frequency

    def analyse(self) -> bool:
        obs_sorted = sorted(self.data.keys())
        rows = len(obs_sorted)
        if rows < 5:
            return False
        freqs = [self.data[o] for o in obs_sorted]
        big_n = 0
        for o, f in zip(obs_sorted, freqs):
            big_n += o * f
        self.p_zero = (self.data[1] / big_n) if 1 in self.data else 0.0

        log_obs = [0.0] * rows
        log_z = [0.0] * rows
        mean_x = mean_y = 0.0
        prev_obs = 0
        for r in range(rows):
            obs = obs_sorted[r]
            k = float(obs_sorted[r + 1]) if r + 1 < rows else float(2 * obs - prev_obs)
            z = 2 * freqs[r] / (k - prev_obs)
            log_obs[r] = math.log(float(obs))
            log_z[r] = math.log(z)
            mean_x += log_obs[r]
            mean_y += log_z[r]
            prev_obs = obs
        mean_x /= rows
        mean_y /= rows
        xys = xsq = 0.0
        for r in range(rows):
            xys += (log_obs[r] - mean_x) * (log_z[r] - mean_y)
            xsq += (log_obs[r] - mean_x) ** 2
        slope = xys / xsq
        intercept = mean_y - slope * mean_x

        def smoothed(i):
            return math.exp(intercept + slope * math.log(float(i)))

        r_star = [0.0] * rows
        indiff = False
        obs_index = {o: i for i, o in enumerate(obs_sorted)}
        for r in range(rows):
            obs = obs_sorted[r]
            obs1 = obs + 1
            y = obs1 * smoothed(obs1) / smoothed(obs)
            nxt = obs_index.get(obs1)
            if nxt is None:
                indiff = True
            elif not indiff:
                next_n = freqs[nxt]
                freq = freqs[r]
                x = obs1 * next_n / float(freq)
                if abs(x - y) <= 1.96 * math.sqrt(
                        float(obs1) ** 2 * next_n / (float(freq) ** 2)
                        * (1 + next_n / float(freq))):
                    indiff = True
                else:
                    r_star[r] = x
            if indiff:
                r_star[r] = y

        big_n_prime = 0.0
        for r in range(rows):
            big_n_prime += freqs[r] * r_star[r]
        self.estimates = {}
        for r in range(rows):
            self.estimates[obs_sorted[r]] = (1 - self.p_zero) * r_star[r] / big_n_prime
        return True

    def estimate(self, observation: int):
        """(found, value); observation 0 -> PZero"""
        if observation == 0:
            return True, self.p_zero
        if observation in self.estimates:
            return True, self.estimates[observation]
        return False, None
