"""Spectral diagnostics: shell-averaged spectra, enstrophy, dissipation.

The turbulence statistics an incompressible-flow user computes from the
fields the models in ``cfd_tpu.models`` evolve. The binning tables (shell
index per rfft mode, Hermitian multiplicities) are built once per shape in
float64 numpy at trace time — the same precompute discipline as every
other operator here — so the device work is one rfftn per component plus
a ``segment_sum``.

Two families:

- **Exact spectral-space statistics** (``energy_spectrum``,
  ``scalar_spectrum``): shell-averaged over the true wavenumber
  ``|k| = sqrt(kx^2 + ky^2 + kz^2)``, normalized so the spectrum sums to
  the corresponding physical-space mean (Parseval):
  ``sum_k E(k) == 0.5 * mean(|u|^2)``.
- **Scheme-consistent physical-space statistics** (``enstrophy``,
  ``dissipation``): evaluated through this package's compact operators
  (curl/gradient), so they measure what the *discrete* model dissipates,
  through the normal ``auto`` routing.

Reference lineage: the reference stops at derivative evaluation; these
diagnostics are beyond its surface, motivated by its CFD consumers (the
LANL CFDNS lineage, /root/reference/lanl-implementation/npts.c:1-7) whose
production runs report exactly these quantities.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..schemes import CompactScheme

__all__ = [
    "spectrum_shells",
    "scalar_spectrum",
    "energy_spectrum",
    "enstrophy",
    "dissipation",
]


@functools.lru_cache(maxsize=32)
def _shell_tables(shape, spacing):
    """(bins, weights, k_centers) for an rfftn over the last three axes.

    ``bins[z, y, x]`` is the integer shell index of each rfft mode, from
    rounding ``|k| / k_min`` with ``k_min`` the smallest nonzero wavenumber
    over the three axes (isotropic boxes: exactly the fundamental 2*pi/L).
    ``weights`` carries the Hermitian multiplicity of the real transform:
    2 for interior kx columns (each stands for itself and its conjugate),
    1 for the self-conjugate kx = 0 and kx = Nyquist planes.
    """
    nz, ny, nx = shape
    dz, dy, dx = spacing
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=dz)
    ky = 2.0 * np.pi * np.fft.fftfreq(ny, d=dy)
    kx = 2.0 * np.pi * np.fft.rfftfreq(nx, d=dx)
    kmag = np.sqrt(
        kz[:, None, None] ** 2 + ky[None, :, None] ** 2 + kx[None, None, :] ** 2
    )
    kmin = min(
        2.0 * np.pi / (n * d) for n, d in ((nz, dz), (ny, dy), (nx, dx))
    )
    bins = np.rint(kmag / kmin).astype(np.int32)
    weights = np.full(kmag.shape, 2.0)
    weights[..., 0] = 1.0
    if nx % 2 == 0:
        weights[..., -1] = 1.0
    n_shells = int(bins.max()) + 1
    k_centers = kmin * np.arange(n_shells)
    return bins, weights, k_centers


def spectrum_shells(shape, spacing):
    """The shell-center wavenumbers ``scalar_spectrum``/``energy_spectrum``
    bin onto for this ``(nz, ny, nx)`` shape and ``(dz, dy, dx)`` spacing
    (float64 numpy, length = number of shells)."""
    from .derivatives import _spacings3

    sp = tuple(float(s) for s in _spacings3(spacing))
    _, _, k_centers = _shell_tables(tuple(int(n) for n in shape[-3:]), sp)
    return k_centers


@functools.partial(jax.jit, static_argnames=("spacing",))
def _shell_power(f, spacing):
    """Shell-summed ``|fhat|^2`` with Hermitian weights, Parseval-normalized
    so the result sums to ``mean(f^2)``."""
    shape = f.shape[-3:]
    bins, weights, _ = _shell_tables(shape, spacing)
    npts = shape[0] * shape[1] * shape[2]
    fh = jnp.fft.rfftn(f, axes=(-3, -2, -1))
    power = (jnp.real(fh) ** 2 + jnp.imag(fh) ** 2) * jnp.asarray(
        weights, jnp.real(fh).dtype
    )
    flat = power.reshape(*f.shape[:-3], -1) / (float(npts) ** 2)
    return jax.ops.segment_sum(
        jnp.moveaxis(flat, -1, 0),
        jnp.asarray(bins.ravel()),
        num_segments=int(bins.max()) + 1,
    )


def scalar_spectrum(f: jax.Array, spacing) -> jax.Array:
    """Shell-averaged power spectrum of a scalar field.

    ``f`` is ``[..., nz, ny, nx]`` on a periodic box; returns ``P`` with
    ``P[s]`` the power in wavenumber shell ``s`` (centers from
    ``spectrum_shells``), normalized so ``sum(P) == mean(f**2)`` exactly
    (Parseval). Leading batch axes are preserved after the shell axis:
    output shape ``[n_shells, ...]``.

    ``spacing`` must be a concrete Python/NumPy value (it is baked into the
    shell tables and the jit cache key); passing a traced value from inside
    a user ``jit`` raises a TracerError.
    """
    from .derivatives import _spacings3

    if f.ndim < 3:
        raise ValueError(f"scalar_spectrum needs [..., nz, ny, nx], got {f.shape}")
    sp = tuple(float(s) for s in _spacings3(spacing))
    return _shell_power(f, sp)


def energy_spectrum(u, spacing) -> jax.Array:
    """Shell-averaged kinetic-energy spectrum E(k) of ``u = (ux, uy, uz)``.

    ``sum(E) == 0.5 * mean(ux^2 + uy^2 + uz^2)`` exactly — the volume-mean
    kinetic energy (``NavierStokes.kinetic_energy``). Shell centers from
    ``spectrum_shells``. Like ``scalar_spectrum``, ``spacing`` must be a
    concrete (static) value, not a traced one.
    """
    from .derivatives import _spacings3

    ux, uy, uz = u
    if not (ux.shape == uy.shape == uz.shape) or ux.ndim < 3:
        raise ValueError(
            f"energy_spectrum needs three equal-shape [..., nz, ny, nx] "
            f"components, got {[c.shape for c in (ux, uy, uz)]}"
        )
    sp = tuple(float(s) for s in _spacings3(spacing))
    return 0.5 * (
        _shell_power(ux, sp) + _shell_power(uy, sp) + _shell_power(uz, sp)
    )


def enstrophy(u, spacing, scheme: CompactScheme) -> jax.Array:
    """Volume-mean enstrophy ``0.5 * mean(|curl u|^2)`` through the compact
    curl. For periodic incompressible
    fields the dissipation rate is ``2 * nu * enstrophy``."""
    from .derivatives import curl

    wx, wy, wz = curl(u, spacing, scheme)
    return 0.5 * jnp.mean(wx * wx + wy * wy + wz * wz)


def dissipation(u, spacing, scheme: CompactScheme, nu: float) -> jax.Array:
    """Viscous dissipation rate ``nu * mean(sum_ij (du_i/dx_j)^2)`` through
    the compact gradient — the rate at which the diffusion term of
    ``models.NavierStokes`` removes kinetic energy (periodic box)."""
    from .derivatives import gradient

    total = 0.0
    for comp in u:
        gx, gy, gz = gradient(comp, spacing, scheme)
        total = total + jnp.mean(gx * gx + gy * gy + gz * gz)
    return nu * total
