"""Port parity: the plain versions of the Schur kernels K3a/b/c
(``pixsfm_tpu_torch/ops/schur_cuda.py``) against the JAX package's Pallas
kernels run through the Pallas interpreter (``schur_pallas.INTERPRET``, as
``tests/test_schur_pallas.py`` runs them) and against its
``schur_term_matvec_ref`` oracle, on the same numpy inputs.

Cases: T in {4, 8, 16}, Np not a multiple of any tile, track holes with
zero W blocks and invalid (slot 0) indices. Tolerance rtol 2e-5 / atol
2e-4, the JAX package's own for these kernels: both sides sum in float32,
in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixsfm_tpu.ops import schur_pallas as sp
from pixsfm_tpu_torch.ops import schur_cuda as sc

TOL = dict(rtol=2e-5, atol=2e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side: among the fast lane's
    parallel workers, torch's default threads only contend for the cores
    (as in ``tests/test_torch_ba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(sp, "INTERPRET", True)


def _problem(seed, T, I=13, Nc=3, k=4, Np=300, holes=0.25):
    rng = np.random.default_rng(seed)
    NR = 6 + k
    O = Np * T
    Bt = rng.normal(size=(NR * 3, O)).astype(np.float32)
    img = rng.integers(0, I, O).astype(np.int32)
    cam = rng.integers(0, Nc, O).astype(np.int32)
    hole = rng.random(O) < holes
    Bt[:, hole] = 0.0
    img[hole] = 0
    cam[hole] = 0
    A = rng.normal(size=(Np, 3, 3)).astype(np.float32)
    Vinv = (np.einsum("pab,pcb->acp", A, A)
            + 3 * np.eye(3)[:, :, None]).astype(np.float32)
    vp = rng.normal(size=(I, 6)).astype(np.float32)
    vc = rng.normal(size=(Nc, k)).astype(np.float32)
    gx = rng.normal(size=(3, Np)).astype(np.float32)
    return dict(Bt=Bt, img=img, cam=cam, Vinv=Vinv, vp=vp, vc=vc, gx=gx,
                T=T, I=I, Nc=Nc, k=k, Np=Np)


def _pack_both(p, tile):
    jx = sp.pack_grid_blocks(jnp.asarray(p["Bt"]), jnp.asarray(p["img"]),
                             jnp.asarray(p["cam"]), jnp.asarray(p["Vinv"]),
                             p["T"], tile=tile)
    tx = sc.pack_grid_blocks(torch.as_tensor(p["Bt"]),
                             torch.as_tensor(p["img"]),
                             torch.as_tensor(p["cam"]),
                             torch.as_tensor(p["Vinv"]), p["T"], tile=tile)
    return jx, tx


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("T", [4, 8, 16])
def test_pack_grid_blocks_matches(T):
    p = _problem(0, T)
    (jB, ji, jc, jV, jP), (tB, ti, tc, tV, tP) = _pack_both(p, 128)
    assert jP == tP == 384
    for a, b in ((jB, tB), (ji, ti), (jc, tc), (jV, tV)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("T", [4, 8, 16])
def test_k3a_matvec_matches_pallas(T):
    p = _problem(1, T)
    (jB, ji, jc, jV, _), (tB, ti, tc, tV, _) = _pack_both(p, 128)
    dims = dict(T=T, I=p["I"], Nc=p["Nc"], k=p["k"])
    up_j, uc_j = sp.schur_term_matvec(
        jnp.asarray(p["vp"].T), jnp.asarray(p["vc"].T), jB, ji, jc, jV,
        tile=128, **dims)
    vpT, vcT = torch.as_tensor(p["vp"].T), torch.as_tensor(p["vc"].T)
    up_t, uc_t = sc.schur_term_matvec(vpT, vcT, tB, ti, tc, tV, **dims)
    _close(up_t, up_j)
    _close(uc_t, uc_j)
    # and the JAX oracle against the port's oracle form
    up_r, uc_r = sp.schur_term_matvec_ref(
        jnp.asarray(p["vp"].T), jnp.asarray(p["vc"].T), jB, ji, jc, jV)
    up_o, uc_o = sc.schur_term_matvec_ref(vpT, vcT, tB, ti, tc, tV)
    _close(up_o, up_r)
    _close(uc_o, uc_r)
    _close(up_t, up_r)


@pytest.mark.parametrize("T", [4, 8, 16])
def test_k3b_rhs_matches_pallas(T):
    p = _problem(2, T)
    (jB, ji, jc, jV, P), (tB, ti, tc, tV, _) = _pack_both(p, 128)
    dims = dict(T=T, I=p["I"], Nc=p["Nc"], k=p["k"])
    gxp = np.concatenate([p["gx"], np.zeros((3, P - p["Np"]), np.float32)],
                         axis=1)
    up_j, uc_j = sp.schur_rhs(jB, ji, jc, jV, jnp.asarray(gxp), tile=128,
                              **dims)
    up_t, uc_t = sc.schur_rhs(tB, ti, tc, tV, torch.as_tensor(gxp), **dims)
    _close(up_t, up_j)
    _close(uc_t, uc_j)


@pytest.mark.parametrize("T", [4, 8, 16])
def test_k3c_backsub_matches_pallas(T):
    p = _problem(3, T)
    (jB, ji, jc, _, _), (tB, ti, tc, _, _) = _pack_both(p, 128)
    dims = dict(T=T, I=p["I"], Nc=p["Nc"], k=p["k"])
    t_j = sp.schur_backsub(jnp.asarray(p["vp"].T), jnp.asarray(p["vc"].T),
                           jB, ji, jc, tile=128, **dims)
    t_t = sc.schur_backsub(torch.as_tensor(p["vp"].T),
                           torch.as_tensor(p["vc"].T), tB, ti, tc, **dims)
    _close(t_t, t_j)
    # padded tail points contribute nothing
    assert not t_t[:, p["Np"]:].any()


def test_plain_versions_only_on_cpu_tensors():
    """The wrappers take the plain path because the tensors lie on the CPU;
    nothing is launched and no counter moves."""
    p = _problem(4, 4)
    _, (tB, ti, tc, tV, _) = _pack_both(p, 128)
    before = dict(sc.launches)
    sc.schur_term_matvec(torch.as_tensor(p["vp"].T),
                         torch.as_tensor(p["vc"].T), tB, ti, tc, tV,
                         T=4, I=p["I"], Nc=p["Nc"], k=p["k"])
    assert sc.launches == before


# Shapes that reach the variants of the CUDA K3a (one and two ranks per
# warp, a rank count that is no power of two, one rank, k = 1 and k = 8),
# with mixed camera slots, holes and a ragged Np: the card holds the kernel
# to the plain version, and these cases hold the plain version to JAX.
EDGE_SHAPES = [dict(T=5, k=4), dict(T=1, k=4), dict(T=8, k=1),
               dict(T=12, k=8), dict(T=5, k=8, I=7, Nc=1)]


@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                s.items()))
def test_k3a_matvec_edge_shapes(shape):
    p = _problem(5, Np=203, holes=0.3, **shape)
    (jB, ji, jc, jV, _), (tB, ti, tc, tV, P) = _pack_both(p, 128)
    assert P == 256 and (ti[:, p["Np"]:] == 0).all()
    dims = dict(T=p["T"], I=p["I"], Nc=p["Nc"], k=p["k"])
    vpT_j, vcT_j = jnp.asarray(p["vp"].T), jnp.asarray(p["vc"].T)
    vpT, vcT = torch.as_tensor(p["vp"].T), torch.as_tensor(p["vc"].T)
    up_t, uc_t = sc.schur_term_matvec(vpT, vcT, tB, ti, tc, tV, **dims)
    assert up_t.shape == (6, p["I"]) and uc_t.shape == (p["k"], p["Nc"])
    # the interpreted Pallas kernel takes all of these shapes
    up_j, uc_j = sp.schur_term_matvec(vpT_j, vcT_j, jB, ji, jc, jV, tile=128,
                                      **dims)
    _close(up_t, up_j)
    _close(uc_t, uc_j)
    # and the JAX oracle
    up_r, uc_r = sp.schur_term_matvec_ref(vpT_j, vcT_j, jB, ji, jc, jV)
    _close(up_t, up_r)
    _close(uc_t, uc_r)
    if p["Nc"] > 1:   # camera slots really are mixed inside a 32-point run
        assert len(np.unique(tc[0, :32].numpy())) > 1


# K3b's CUDA variants: EDGE_SHAPES reach the fused one with one and two
# ranks per warp; T = 16 is its last T, T = 20 takes the one-pass kernel.
RHS_EDGE_SHAPES = EDGE_SHAPES + [dict(T=16, k=4), dict(T=20, k=4)]


@pytest.mark.parametrize("shape", RHS_EDGE_SHAPES,
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                s.items()))
def test_k3b_rhs_edge_shapes(shape):
    p = _problem(6, Np=203, holes=0.3, **shape)
    (jB, ji, jc, jV, P), (tB, ti, tc, tV, _) = _pack_both(p, 128)
    dims = dict(T=p["T"], I=p["I"], Nc=p["Nc"], k=p["k"])
    gxp = np.concatenate([p["gx"], np.zeros((3, P - p["Np"]), np.float32)],
                         axis=1)
    up_j, uc_j = sp.schur_rhs(jB, ji, jc, jV, jnp.asarray(gxp), tile=128,
                              **dims)
    up_t, uc_t = sc.schur_rhs(tB, ti, tc, tV, torch.as_tensor(gxp), **dims)
    _close(up_t, up_j)
    _close(uc_t, uc_j)


def test_accumulator_planes_share_one_buffer():
    """The CUDA wrappers clear both accumulators with one fill: the planes
    are contiguous views of one zeroed buffer."""
    up, uc = sc._zero_planes(7, 3, 4, torch.device("cpu"))
    assert up.shape == (6, 7) and uc.shape == (4, 3)
    assert up.is_contiguous() and uc.is_contiguous()
    assert not up.any() and not uc.any()
    assert up.untyped_storage().data_ptr() == uc.untyped_storage().data_ptr()
