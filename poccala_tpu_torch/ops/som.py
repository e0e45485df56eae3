"""Self-organizing-map clustering and particle-swarm optimization (port
of ``poccala_tpu/ops/som.py``).

Replaces the reference's leaf modules ``StatisticalModel/ANN.py:26-137``
(``som``, ``p_som``) and ``StatisticalModel/EA.py:23-127`` (particle
swarm with linearly-decaying inertia), reachable there via
``ClusterInitialization.som`` (``Clustering.py:1176-1183``).  Where JAX
scans, these are plain loops of tensor ops: the SOM over training steps
with a vectorized best-matching-unit search, PSO over iterations with the
whole swarm updated at once (the objective ``vmap``-ed over particles).

Randomness: where JAX takes a ``jax.random`` key, these take a
``torch.Generator`` on the data's device and draw from it in order; the
streams differ from JAX's, so results agree with it in their properties,
not draw for draw.
"""

from __future__ import annotations

import math

import torch

from poccala_tpu_torch.ops.distance import pairwise_euclidean


def som(
    generator: torch.Generator,
    x: torch.Tensor,
    num_neurons: int,
    sigma0: float = 0.6,
    tau1: float = 20.0,
    eta0: float = 0.6,
    tau2: float = 20.0,
    steps: int = 500,
    weights0: torch.Tensor | None = None,
):
    """Train a 1-D SOM (``ANN.som``, ``ANN.py:46-83``).

    Exponentially-decaying neighborhood width ``σ(t) = σ0·exp(-t/τ1)``
    and learning rate ``η(t) = η0·exp(-t/τ2)`` (``ANN.py:60-63``); each
    step presents one sample (drawn at random, as in JAX), finds the
    best-matching unit and pulls neighbors toward it with a Gaussian
    neighborhood.

    :param x: ``[N, D]`` data
    :returns: (``weights [num_neurons, D]``, ``assign [N]``)
    """
    n, d = x.shape
    dev = x.device
    if weights0 is None:
        weights0 = torch.rand((num_neurons, d), generator=generator,
                              device=dev, dtype=x.dtype)
    neuron_pos = torch.arange(num_neurons, dtype=x.dtype, device=dev)
    sample_idx = torch.randint(0, n, (steps,), generator=generator,
                               device=dev)
    weights = weights0
    for t in range(steps):
        xi = x[sample_idx[t]]
        dist = torch.sum((weights - xi[None, :]) ** 2, dim=-1)
        bmu = torch.argmin(dist)
        sigma = sigma0 * math.exp(-t / tau1)
        eta = eta0 * math.exp(-t / tau2)
        h = torch.exp(-((neuron_pos - neuron_pos[bmu]) ** 2)
                      / max(2.0 * sigma * sigma, 1e-12))
        weights = weights + eta * h[:, None] * (xi[None, :] - weights)
    assign = torch.argmin(pairwise_euclidean(x, weights), dim=-1)
    return weights, assign


def quantization_error(weights, x):
    """Mean distance of each point to its BMU (the PSO fitness for SOM
    initialization)."""
    return torch.mean(torch.min(pairwise_euclidean(x, weights), dim=-1)
                      .values)


def pso(
    generator: torch.Generator,
    objective,
    num_particles: int,
    dim: int,
    scope_x: tuple[float, float] = (-1.0, 1.0),
    scope_v: tuple[float, float] = (-1.0, 1.0),
    iters: int = 100,
    w_max: float = 0.9,
    w_min: float = 0.4,
    c1: float = 2.0,
    c2: float = 2.0,
):
    """Global-best particle swarm on the generator's device, minimizing
    ``objective([dim]) -> scalar`` (``EA.pso``, ``EA.py:76-127``):
    velocity update with linearly decaying inertia ``w(t) = w_max -
    t·(w_max-w_min)/T`` (``EA.py:100-104``), cognitive/social constants
    c1/c2, positions and velocities clipped to their scopes
    (``EA.init_particle``, ``EA.py:39-52``).

    :returns: (best position ``[dim]``, best value)
    """
    dev = generator.device

    def uniform(lo, hi):
        u = torch.rand((num_particles, dim), generator=generator, device=dev)
        return lo + (hi - lo) * u

    fit = torch.func.vmap(objective)
    pos = uniform(*scope_x)
    vel = uniform(*scope_v)
    fitness = fit(pos)
    pbest, pbest_val = pos, fitness
    g_idx = torch.argmin(fitness)
    gbest, gbest_val = pos[g_idx], fitness[g_idx]
    for t in range(iters):
        w = w_max - t * (w_max - w_min) / iters
        r1 = uniform(0.0, 1.0)
        r2 = uniform(0.0, 1.0)
        vel = (w * vel + c1 * r1 * (pbest - pos)
               + c2 * r2 * (gbest[None, :] - pos))
        vel = torch.clamp(vel, scope_v[0], scope_v[1])
        pos = torch.clamp(pos + vel, scope_x[0], scope_x[1])
        fitness = fit(pos)
        improved = fitness < pbest_val
        pbest = torch.where(improved[:, None], pos, pbest)
        pbest_val = torch.where(improved, fitness, pbest_val)
        g_idx = torch.argmin(pbest_val)
        better = pbest_val[g_idx] < gbest_val
        gbest = torch.where(better, pbest[g_idx], gbest)
        gbest_val = torch.where(better, pbest_val[g_idx], gbest_val)
    return gbest, gbest_val


def p_som(generator: torch.Generator, x, num_neurons: int,
          pso_particles: int = 16, pso_iters: int = 50, **som_kwargs):
    """PSO-initialized SOM (``ANN.p_som``, ``ANN.py:100-130``): the swarm
    searches for initial neuron weights minimizing quantization error,
    then the SOM refines them."""
    n, d = x.shape
    lo = float(torch.min(x))
    hi = float(torch.max(x))

    def objective(flat):
        return quantization_error(flat.reshape(num_neurons, d), x)

    best, _ = pso(
        generator, objective, pso_particles, num_neurons * d,
        scope_x=(lo, hi), scope_v=(-(hi - lo) / 10.0, (hi - lo) / 10.0),
        iters=pso_iters,
    )
    return som(generator, x, num_neurons,
               weights0=best.reshape(num_neurons, d), **som_kwargs)
