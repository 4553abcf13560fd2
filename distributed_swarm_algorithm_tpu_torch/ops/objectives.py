"""Benchmark objective functions for swarm optimization.

Counterpart of ``ops/objectives.py`` of the JAX package.  Every objective
is a pure ``[..., D] -> [...]`` function of a float tensor, batched over
the leading axes, on any device, and differentiable by autograd (the
memetic refinement differentiates them).  The fused kernels evaluate the
transposed registry ``ops/cuda/pso_fused.OBJECTIVES_T`` instead.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def _index_1based(x: torch.Tensor) -> torch.Tensor:
    """[D] 1..D in ``x``'s dtype, on its device."""
    return torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)


def sphere(x):
    """f(x) = sum x_i^2; global min 0 at origin."""
    return torch.sum(x * x, dim=-1)


def rastrigin(x):
    """f(x) = 10 D + sum(x^2 - 10 cos(2 pi x)); global min 0 at origin."""
    d = x.shape[-1]
    return 10.0 * d + torch.sum(x * x - 10.0 * torch.cos(_TWO_PI * x), dim=-1)


def ackley(x):
    """Ackley; global min 0 at origin."""
    d = x.shape[-1]
    s1 = torch.sum(x * x, dim=-1) / d
    s2 = torch.sum(torch.cos(_TWO_PI * x), dim=-1) / d
    return (
        -20.0 * torch.exp(-0.2 * torch.sqrt(s1))
        - torch.exp(s2)
        + 20.0
        + math.e
    )


def rosenbrock(x):
    """Rosenbrock valley; global min 0 at (1,...,1)."""
    a = x[..., 1:] - x[..., :-1] ** 2
    b = 1.0 - x[..., :-1]
    return torch.sum(100.0 * a * a + b * b, dim=-1)


def griewank(x):
    i = _index_1based(x)
    return (
        torch.sum(x * x, dim=-1) / 4000.0
        - torch.prod(torch.cos(x / torch.sqrt(i)), dim=-1)
        + 1.0
    )


def schwefel(x):
    d = x.shape[-1]
    return 418.9829 * d - torch.sum(
        x * torch.sin(torch.sqrt(torch.abs(x))), dim=-1
    )


def levy(x):
    """Levy function; global min 0 at (1,...,1)."""
    w = 1.0 + (x - 1.0) / 4.0
    head = torch.sin(math.pi * w[..., 0]) ** 2
    wi = w[..., :-1]
    mid = torch.sum(
        (wi - 1.0) ** 2
        * (1.0 + 10.0 * torch.sin(math.pi * wi + 1.0) ** 2),
        dim=-1,
    )
    wd = w[..., -1]
    tail = (wd - 1.0) ** 2 * (1.0 + torch.sin(_TWO_PI * wd) ** 2)
    return head + mid + tail


def zakharov(x):
    """Zakharov; global min 0 at origin (unimodal, ill-conditioned)."""
    i = _index_1based(x)
    s1 = torch.sum(x * x, dim=-1)
    s2 = torch.sum(0.5 * i * x, dim=-1)
    return s1 + s2**2 + s2**4


def styblinski_tang(x):
    """Styblinski-Tang, shifted so the global min is 0 (at x_i ~ -2.9035;
    the canonical form has min -39.166 D)."""
    d = x.shape[-1]
    return (
        0.5 * torch.sum(x**4 - 16.0 * x * x + 5.0 * x, dim=-1)
        + 39.16616570377142 * d
    )


def michalewicz(x):
    """Michalewicz (m=10): steep ridges, D! local minima; min < 0."""
    i = _index_1based(x)
    return -torch.sum(
        torch.sin(x) * torch.sin(i * x * x / math.pi) ** 20, dim=-1
    )


def _michalewicz_centered(x):
    # Michalewicz's canonical domain is [0, pi]; the framework's domains
    # are symmetric half-widths, so center at pi/2: x_search = x + pi/2.
    return michalewicz(x + math.pi / 2.0)


# Registry: name -> (fn, canonical search-domain half-width)
OBJECTIVES = {
    "sphere": (sphere, 5.12),
    "rastrigin": (rastrigin, 5.12),
    "ackley": (ackley, 32.768),
    "rosenbrock": (rosenbrock, 2.048),
    "griewank": (griewank, 600.0),
    "schwefel": (schwefel, 500.0),
    "levy": (levy, 10.0),
    "zakharov": (zakharov, 10.0),
    "styblinski_tang": (styblinski_tang, 5.0),
    "michalewicz": (_michalewicz_centered, math.pi / 2.0),
}


def get_objective(name: str):
    """Return (fn, domain_half_width) for a registered objective."""
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise KeyError(
            f"unknown objective {name!r}; available: {sorted(OBJECTIVES)}"
        ) from None
