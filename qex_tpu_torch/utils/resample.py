"""Jackknife and bootstrap resampling with blocking against
autocorrelation (a copy of ``qex_tpu.utils.resample``; QEX resample).
Host-side numpy: measurement series are short."""

from __future__ import annotations

import numpy as np


def blocked(data: np.ndarray, block: int) -> np.ndarray:
    """Means of consecutive blocks (the remainder is dropped)."""
    data = np.asarray(data, float)
    n = (len(data) // block) * block
    return data[:n].reshape(-1, block).mean(axis=1)


def jackknife(data, fn=np.mean, block: int = 1):
    """Leave-one-out jackknife estimate and error of fn(data), after
    blocking the series by ``block``; returns (estimate, error) with
    the estimate bias-corrected."""
    d = blocked(np.asarray(data, float), block)
    n = len(d)
    if n < 2:
        return float(fn(d)), float("nan")
    full = float(fn(d))
    parts = np.array([fn(np.delete(d, i)) for i in range(n)], float)
    var = (n - 1) / n * np.sum((parts - parts.mean()) ** 2)
    est = n * full - (n - 1) * parts.mean()
    return float(est), float(np.sqrt(var))


def bootstrap(data, fn=np.mean, n_samples: int = 1000, block: int = 1,
              seed: int = 0):
    """Bootstrap estimate and error of fn(data)."""
    d = blocked(np.asarray(data, float), block)
    rng = np.random.default_rng(seed)
    n = len(d)
    stats = np.array([fn(d[rng.integers(0, n, n)])
                      for _ in range(n_samples)], float)
    return float(fn(d)), float(stats.std(ddof=1))


def autocorrelation_time(data, max_lag: int | None = None) -> float:
    """Integrated autocorrelation time with automatic windowing
    (Madras-Sokal): tau_int = 1/2 + sum_t rho(t), window at 5 tau."""
    d = np.asarray(data, float)
    d = d - d.mean()
    n = len(d)
    if n < 4 or d.std() == 0:
        return 0.5
    max_lag = max_lag or n // 4
    var = np.dot(d, d) / n
    tau = 0.5
    for t in range(1, max_lag):
        rho = np.dot(d[:-t], d[t:]) / ((n - t) * var)
        tau += rho
        if t >= 5 * tau:
            break
    return float(max(tau, 0.5))
