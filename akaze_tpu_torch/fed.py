"""Fast Explicit Diffusion (FED) time-step planning.

Pure host-side math replicating the semantics of the reference planner
(reference: fed.cpp:41-148, itself derived from Grewenig et al.).  The output
tau tables are static Python tuples: the fused sublevel kernel receives a
whole sublevel's table as a launch argument, replacing the per-step kernel
launches of the reference hot loop (akaze.cpp:383-391).

A copy of ``akaze_tpu/fed.py``: the port must not import the JAX package.
"""

from __future__ import annotations

import math
from typing import List


def _is_prime(number: int) -> bool:
    """Primality test matching fed_is_prime_internal (fed.cpp:122-148)."""
    if number <= 1:
        return False
    if number in (2, 3, 5, 7):
        return True
    if number % 2 == 0 or number % 3 == 0 or number % 5 == 0 or number % 7 == 0:
        return False
    upper = int(math.sqrt(number + 1.0))
    d = 11
    while d <= upper:
        if number % d == 0:
            return False
        d += 2
    return True


def _tau_internal(n: int, scale: float, tau_max: float,
                  reordering: bool) -> List[float]:
    """Build (and optionally kappa-permute) the tau cycle (fed.cpp:63-119)."""
    if n <= 0:
        return []
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    tauh = [d / (math.cos(math.pi * (2.0 * k + 1.0) * c) ** 2)
            for k in range(n)]
    if not reordering:
        return tauh

    # kappa-cycle permutation with kappa = n/2 modulo the next prime > n
    # (fed.cpp:95-116).
    kappa = n // 2
    prime = n + 1
    while not _is_prime(prime):
        prime += 1
    tau = [0.0] * n
    k = 0
    for l in range(n):
        while True:
            index = ((k + 1) * kappa) % prime - 1
            if index < n:
                break
            k += 1
        tau[l] = tauh[index]
        k += 1
    return tau


def fed_tau_by_cycle_time(t: float, tau_max: float,
                          reordering: bool) -> List[float]:
    """Tau steps whose sum reaches cycle time ``t`` (fed.cpp:48-60)."""
    n = int(math.ceil(math.sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1.0e-8) + 0.5)
    scale = 3.0 * t / (tau_max * n * (n + 1))
    return _tau_internal(n, scale, tau_max, reordering)


def fed_tau_by_process_time(T: float, M: int, tau_max: float,
                            reordering: bool) -> List[float]:
    """Tau steps for total process time ``T`` over ``M`` cycles (fed.cpp:41-45)."""
    return fed_tau_by_cycle_time(T / float(M), tau_max, reordering)
