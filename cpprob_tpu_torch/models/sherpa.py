"""SHERPA-family physics models — counterpart of ``cpprob_tpu/models/sherpa.py``
(reference ``src/models/sherpa_mini.cpp``, ``src/models/calorimeter.cpp``
and the ABC-observe structure of ``src/models/sherpa.cpp:49-68``).

The external SHERPA event generator is replaced, as in the reference's own
``sherpa_mini`` toy, by a synthetic channel-conditioned event source; the
structure the framework sees is the reference's: latent decay channel ->
energy deposits -> histogram -> ABC/MVN observe -> predicts ("Channel" /
momentum components).

Written for one particle and run over a population under
``torch.func.vmap``: the deposit loops are one batched MVN draw and a
scatter-add histogram (``Tensor.index_add`` on a flattened bin index, out
of place, which batches under vmap), and the calorimeter's Poisson deposit
count is a capped draw with an active-deposit mask (static shapes).  On
the CPU the scatter-add sums in a fixed order.  On the card its float
atomics sum in any order: the calorimeter adds one constant
(``_E_DEPOSIT``) a deposit, so its voxel sums do not depend on the order,
while ``sherpa_mini``'s four momenta carry different weights and its
histogram may differ in the last bits between runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import as_tensor, observe, predict, sample
from ..distributions import MultivariateNormalDiag, Poisson, Uniform, make_abc

__all__ = [
    "sherpa_mini",
    "sherpa_mini_wrapper",
    "calo_simulation",
    "sherpa_calorimeter_wrapper",
    "CHANNEL_MOMENTA",
]

# The four fixed final-state four-momenta (x, y, z, E) of sherpa_mini.cpp:45-48.
CHANNEL_MOMENTA = np.array(
    [
        [3.12206631, 0.18609799, -0.13257316, 3.16910447],
        [0.46751203, -0.18594433, -0.08841184, 0.52956513],
        [3.03845425, -0.35807276, 0.05962087, 3.06324252],
        [3.37196741, 0.35791909, 0.16136414, 3.39474722],
    ],
    np.float32,
)

_NETA = _NPHI = 100
_DEPOSIT_WIDTH = 0.05
_NSAMPLES = 1000
_OBS_WIDTH = 0.01


def _channel():
    """The latent decay channel: ``floor(U[0, 4))`` as an integer (int64;
    the reference's int32 values)."""
    select_ran = sample(Uniform(0.0, 4.0), addr="channel_u")
    return torch.floor(select_ran).long()


def _eta_phi(mom: torch.Tensor):
    """Pseudorapidity / azimuth of a four-momentum (x, y, z, E)."""
    px, py, pz = mom[..., 0], mom[..., 1], mom[..., 2]
    pt = torch.sqrt(px * px + py * py)
    eta = torch.asinh(pz / torch.clamp(pt, min=1e-12))
    phi = torch.atan2(py, px)
    return eta, phi


def _histogram2d(x, y, w, n_bins, lo, hi):
    """Scatter-add 2-D histogram (YODA::Histo2D::fill equivalent): out of
    place on a flattened bin index, so it batches under vmap."""
    ix = torch.floor((x - lo) / (hi - lo) * n_bins).long()
    iy = torch.floor((y - lo) / (hi - lo) * n_bins).long()
    ok = (ix >= 0) & (ix < n_bins) & (iy >= 0) & (iy < n_bins)
    flat = torch.clamp(ix, 0, n_bins - 1) * n_bins + torch.clamp(iy, 0, n_bins - 1)
    hist = torch.zeros(n_bins * n_bins, dtype=w.dtype, device=w.device)
    return hist.index_add(0, flat, torch.where(ok, w, torch.zeros_like(w))).reshape(
        n_bins, n_bins)


def sherpa_mini():
    """Latent channel ~ floor(U[0,4)); deposit 1000 2-D normal samples per
    selected momentum around (eta, phi), weight E/1000, into a 100x100
    histogram over [-1,1]^2 (``sherpa_mini.cpp:63-84``).  Returns the
    flattened histogram."""
    channel = _channel()
    predict(channel, "Channel")

    moms = as_tensor(CHANNEL_MOMENTA)
    eta, phi = _eta_phi(moms)            # (4,), (4,)
    energies = moms[:, 3]

    # one uncontrolled vector site supplies all deposit randomness
    eps = sample(
        MultivariateNormalDiag(torch.zeros((4, _NSAMPLES, 2), device=moms.device), 1.0),
        addr="deposits",
        control=False,
    )
    centers = torch.stack([eta, phi], dim=-1)[:, None, :]     # (4, 1, 2)
    pts = centers + _DEPOSIT_WIDTH * eps                      # (4, S, 2)

    active = (torch.arange(4, device=moms.device) <= channel).float()  # momenta 0..channel
    w = (energies / _NSAMPLES) * active                      # (4,)
    weights = w[:, None].expand(4, _NSAMPLES)

    hist = _histogram2d(
        pts[..., 0].reshape(-1), pts[..., 1].reshape(-1), weights.reshape(-1),
        _NETA, -1.0, 1.0,
    )
    return hist.reshape(-1)


def sherpa_mini_wrapper(test_image):
    """Observe the synthetic histogram under MVN(image, 0.01)
    (``sherpa_mini.cpp:87-93``)."""
    img = sherpa_mini()
    observe(
        MultivariateNormalDiag(img, _OBS_WIDTH),
        as_tensor(test_image, torch.float32).reshape(-1),
        addr="image",
    )
    return img


# ---------------------------------------------------------------------------
# 3-D calorimeter (calorimeter.cpp)
# ---------------------------------------------------------------------------

_NBINX = _NBINY = 35
_NBINZ = 20
_Z_BEGIN = 4.0
_Z_END = 15.0
_XY_LIM = 3.0
_E_DEPOSIT = 0.005      # min_energy_deposit() in GeV (calorimeter.cpp:17)
_MAX_DEPOSITS = 4096    # static cap on the Poisson deposit count


def _shower_parameters(is_em: torch.Tensor):
    """EM vs hadronic shower shape (``calorimeter.cpp:56-76``)."""
    sampling_fraction = torch.where(is_em, 0.5, 0.25)
    em = torch.tensor([0.2, 0.2, 0.50], device=is_em.device)
    had = torch.tensor([0.2, 0.2, 1.00], device=is_em.device)
    return sampling_fraction, torch.where(is_em, em, had)


def _rot_y(v, theta):
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def _rot_z(v, phi):
    c, s = torch.cos(phi), torch.sin(phi)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)


def calo_simulation(particles, n_bins=(_NBINX, _NBINY, _NBINZ),
                    max_deposits: int = _MAX_DEPOSITS):
    """Voxel deposition simulator (``calo_simulation``,
    ``calorimeter.cpp:135-170``); default 35x35x20 bins as the reference.

    ``particles``: (P, 8) rows [x, y, z, energy, theta, phi, pdg_id,
    calo_visible] (the reference's particle_data layout).  Returns the voxel
    histogram ``n_bins``; ``max_deposits`` caps the Poisson deposit count
    (static shape).
    """
    nbx, nby, nbz = n_bins
    particles = as_tensor(particles, torch.float32)
    dev = particles.device
    P = particles.shape[0]
    hist = torch.zeros(nbx * nby * nbz, device=dev)
    slot = torch.arange(max_deposits, device=dev)
    e_dep = torch.full((), _E_DEPOSIT, device=dev)

    for p in range(P):
        row = particles[p]
        energy, theta, phi = row[3], row[4], row[5]
        pdg_id = row[6]
        visible = (row[7] > 0) & (pdg_id != -99999)
        is_em = torch.abs(pdg_id) == 11.0  # electron/photon-like
        sampling_fraction, widths = _shower_parameters(is_em)
        mean_interactions = energy * sampling_fraction / _E_DEPOSIT

        n = sample(
            Poisson(torch.clamp(mean_interactions, min=1e-6)),
            addr=f"n_deposits[{p}]", control=False,
        )
        n = torch.clamp(n, max=max_deposits)

        shower_depth = 2.0 * 5.0 * widths[2]
        r_surface = _Z_BEGIN / torch.cos(theta)
        r_factor = 1.0 + (shower_depth / 2.0) * torch.cos(theta) / _Z_BEGIN
        center = torch.tensor([0.0, 0.0, 1.0], device=dev) * r_surface * r_factor

        eps = sample(
            MultivariateNormalDiag(torch.zeros((max_deposits, 3), device=dev), 1.0),
            addr=f"deposit_eps[{p}]", control=False,
        )
        pts = center + widths * eps                       # (M, 3)
        pts = _rot_z(_rot_y(pts, theta), phi)

        ix = torch.floor((pts[:, 0] + _XY_LIM) / (2 * _XY_LIM) * nbx).long()
        iy = torch.floor((pts[:, 1] + _XY_LIM) / (2 * _XY_LIM) * nby).long()
        iz = torch.floor((pts[:, 2] - _Z_BEGIN) / (_Z_END - _Z_BEGIN) * nbz).long()
        mask = (
            (slot < n)
            & (ix >= 0) & (ix < nbx)
            & (iy >= 0) & (iy < nby)
            & (iz >= 0) & (iz < nbz)
            & visible
        )
        flat = ((torch.clamp(ix, 0, nbx - 1) * nby + torch.clamp(iy, 0, nby - 1)) * nbz
                + torch.clamp(iz, 0, nbz - 1))
        hist = hist.index_add(0, flat, torch.where(mask, e_dep, torch.zeros_like(e_dep)))
    return hist.reshape(nbx, nby, nbz)


def _synthetic_tau_decay():
    """Channel-conditioned synthetic event source standing in for the external
    SHERPA generator (the reference's out-of-process HEP package).

    The calorimeter face sits on the detector z-axis (z in [4, 15]); the
    mother momentum of these events points along +x, so polar angles are
    measured **relative to the mother's flight axis** (theta = angle from
    +x, phi around it) — a fixed lab rotation that aims the decay products
    into the detector.  Showers are EM (pdg 11) so the widest-angle channel
    still deposits inside the (+-3)^2 transverse window; product 3 (only in
    channel 3) is a pion (pdg 211), so the hadronic shower branch
    (sampling 0.25, z-width 1.0; ``calorimeter.cpp:56-76``) runs too."""
    channel = _channel()
    moms = as_tensor(CHANNEL_MOMENTA)
    dev = moms.device
    active = (torch.arange(4, device=dev) <= channel)[:, None].float()
    px, py, pz, e = moms[:, 0], moms[:, 1], moms[:, 2], moms[:, 3]
    # polar angle from the mother axis (+x); azimuth in the (y, z) plane
    theta = torch.acos(px / torch.sqrt(px**2 + py**2 + pz**2))
    phi = torch.atan2(pz, py)
    pdg = torch.tensor([11.0, 11.0, 11.0, 211.0], device=dev)
    particles = torch.stack(
        [px, py, pz, e, theta, phi, pdg, torch.ones((4,), device=dev)], dim=-1,
    ) * active  # inactive rows zeroed (calo_visible=0 -> skipped)
    mother = torch.sum(moms[:, :3] * active, dim=0)
    return channel, mother, particles


def sherpa_calorimeter_wrapper(observed_histo, n_bins=(_NBINX, _NBINY, _NBINZ),
                               max_deposits: int = _MAX_DEPOSITS,
                               abc_variance: str = "poisson",
                               abc_tolerance_scale: float = 1.0,
                               abc_temper=1.0):
    """Full SHERPA-model structure (``sherpa.cpp:49-68``): simulate the decay,
    run the calorimeter, **ABC-observe** the voxel histogram (dirac sampler +
    MVN approximate logpdf), predict channel + mother momentum.
    ``n_bins``/``max_deposits`` scale the volume (default: the reference's
    35x35x20).

    ``abc_variance`` picks the per-voxel tolerance of the approximate dirac:
    ``"poisson"`` (default; Var = ``_E_DEPOSIT * value``, floor one
    deposit: the exact counting variance of the quantized simulator) or
    ``"reference"`` (``sherpa.cpp:61``'s Var = value, floor 1e-2).
    ``abc_tolerance_scale`` multiplies the per-voxel std (the ABC kernel
    bandwidth); ``abc_temper`` (a number or a tensor) divides the whole ABC
    log-kernel, a power posterior that keeps the ranking of simulated
    templates and shrinks the log-weight spread by the same factor (see the
    reference's docstring for the trade-offs of each).
    """
    channel, mother, particles = _synthetic_tau_decay()
    calo = calo_simulation(particles, n_bins=n_bins, max_deposits=max_deposits)
    flat = calo.reshape(-1)
    if abc_variance == "poisson":
        std = torch.sqrt(torch.clamp(flat * _E_DEPOSIT, min=_E_DEPOSIT**2))
    elif abc_variance == "reference":
        std = torch.sqrt(torch.clamp(flat, min=1e-2))
    else:
        raise ValueError(f"unknown abc_variance {abc_variance!r}")
    std = std * abc_tolerance_scale
    approx = MultivariateNormalDiag(flat, std)
    inv_temper = 1.0 / abc_temper
    abc = make_abc(
        sampler=lambda generator: flat,
        logpdf_fn=lambda x: inv_temper * approx.log_prob(
            as_tensor(x, torch.float32).reshape(-1)),
    )
    observe(abc, observed_histo, addr="calo")
    predict(channel, "Decay Channel")
    predict(mother[0], "Momentum X")
    predict(mother[1], "Momentum Y")
    predict(mother[2], "Momentum Z")
    return calo
