"""Generative models as plain Python functions with `sample` statements,
turned into paired simulate / logpdf functions (reference @fwdmodel,
src/simpleppl.jl:7-101).

Counterpart of ``cmblensing_tpu/models/fwdmodel.py``. A model is written

    def model(ds, theta, sample):
        f   = sample("f",   MvNormal(0, ds.Cf(theta)))
        phi = sample("phi", MvNormal(0, ds.Cphi(theta)))
        d   = sample("d",   MvNormal(ds.M(theta) @ (ds.L(phi) @ f), ds.Cn(theta)))
        return dict(f=f, phi=phi, d=d)

and `simulate(model)` / `logpdf(model)` give the simulation and the log
density: conditioning is passing a value for a named site. Each site
draws from its own torch.Generator, seeded from one number drawn from
the caller's generator and the crc32 of the site's name (the JAX
package folds the name's crc32 into its key), so conditioning one site
leaves the draws of the others as they were, and no two sites share a
stream.
"""
from __future__ import annotations

import zlib

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def site_generator(generator, base, name):
    """The generator of site `name`: on `generator`'s device, seeded from
    `base` (one draw of that generator) and the crc32 of the name."""
    g = torch.Generator(device=generator.device)
    g.manual_seed((base + zlib.crc32(name.encode()) * _GOLDEN) % 2 ** 64)
    return g


def simulate(model):
    """sim(generator, *args, **conditioned): every site not conditioned on
    drawn (each from its own generator, see the module docstring), and the
    model's return value. Conditioning on a name that is no site raises."""

    def sim(generator, *args, **conditioned):
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
        seen = set()

        def sample(name, dist):
            seen.add(name)
            if conditioned.get(name) is not None:
                return conditioned[name]
            return dist.sample(site_generator(generator, base, name))

        out = model(*args, sample=sample)
        unknown = set(conditioned) - seen
        if unknown:
            raise ValueError(f"conditioned on unknown site(s) {sorted(unknown)}; "
                             f"model sites are {sorted(seen)}")
        return out

    return sim


def logpdf(model):
    """lp(*args, **values): the sum of every site's logpdf at its value (a
    site without a value raises)."""
    return loglikelihood(model, latents=())


def loglikelihood(model, latents):
    """ll(*args, **values): the sum of the logpdfs of the sites NOT in
    `latents` (reference src/simpleppl.jl:94); every site needs a
    value."""

    def ll(*args, **values):
        total = [0.0]

        def sample(name, dist):
            if values.get(name) is None:
                raise ValueError(f"the logpdf needs a value for site '{name}'")
            v = values[name]
            if name not in latents:
                total[0] = total[0] + dist.logpdf(v)
            return v

        model(*args, sample=sample)
        return total[0]

    return ll
