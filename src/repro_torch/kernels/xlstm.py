"""CUDA wrappers for the xLSTM recurrences (``csrc/xlstm.cu``).

Replaces no Pallas kernel: the reference runs the mLSTM and sLSTM cells as
``lax.scan`` over time (``src/repro/models/xlstm.py:104`` and ``:183``).
Each wrapper is one launch over all S steps that updates the state in
place in its own dtype (bf16 in a bf16 cache, f32 otherwise), as the
reference casts its cache to f32 before the scan and back after it.

``mlstm_scan_cuda`` and ``slstm_scan_cuda`` take CUDA tensors only;
``kernels.ops`` routes CPU tensors to the plain versions
``kernels.ref.mlstm_scan_ref`` / ``slstm_scan_ref``.  Both take a head
width Dh that is a multiple of 16 up to 384 (xlstm-125m's 384 and 192, the
reduced config's 32 and 16).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import aligned16, check_launch, load_library

MAX_HEAD_DIM = 384
HEAD_DIM_STEP = 16
MAX_GRID_Y = 65535              # B * H rides the mLSTM grid's y
STATE_DTYPES = (torch.float32, torch.bfloat16)


def _check_head_dim(Dh: int) -> None:
    if Dh % HEAD_DIM_STEP or not HEAD_DIM_STEP <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim Dh={Dh} must be a multiple of {HEAD_DIM_STEP} "
                         f"up to {MAX_HEAD_DIM}")


def _check_cuda(named) -> None:
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")


def _check_state(named, dtype) -> None:
    for name, t in named:
        if t.dtype != dtype or dtype not in STATE_DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the state is all float32 or all bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (it is updated in place)")


def check_mlstm_inputs(q, k, v, i_raw, f_raw, C, n, m) -> None:
    """Raise unless q, k, v [B, S, H, Dh], i_raw, f_raw [B, S, H] (f32) and
    the state C [B, H, Dh, Dh], n [B, H, Dh], m [B, H] (contiguous, all f32
    or all bf16) fit together, S >= 1, Dh is a multiple of 16 up to 384 and
    every tensor is on a CUDA device."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, Dh], got shape {tuple(q.shape)}")
    B, S, H, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S, H, Dh):
            raise ValueError(f"{name} {tuple(t.shape)} does not fit q {tuple(q.shape)}")
    for name, t in (("i_raw", i_raw), ("f_raw", f_raw)):
        if tuple(t.shape) != (B, S, H):
            raise ValueError(f"{name} {tuple(t.shape)} is not [B, S, H] = {(B, S, H)}")
    for name, t, shape in (("C", C, (B, H, Dh, Dh)), ("n", n, (B, H, Dh)), ("m", m, (B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not {shape}")
    if S < 1:
        raise ValueError("the scan needs at least one step")
    _check_head_dim(Dh)
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds {MAX_GRID_Y}")
    _check_cuda((("q", q), ("k", k), ("v", v), ("i_raw", i_raw), ("f_raw", f_raw), ("C", C),
                 ("n", n), ("m", m)))
    for name, t in (("q", q), ("k", k), ("v", v), ("i_raw", i_raw), ("f_raw", f_raw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
    _check_state((("C", C), ("n", n), ("m", m)), C.dtype)


def check_slstm_inputs(w_in, r_z, r_i, r_f, r_o, c, n, h, m) -> None:
    """Raise unless w_in [B, S, 4 H Dh] (f32), r_z, r_i, r_f, r_o
    [H, Dh, Dh] (all f32 or all bf16) and the state c, n, h, m [B, H, Dh]
    (contiguous, all f32 or all bf16) fit together, S >= 1, Dh is a
    multiple of 16 up to 384 and every tensor is on a CUDA device."""
    if r_z.dim() != 3 or r_z.shape[1] != r_z.shape[2]:
        raise ValueError(f"r_z must be [H, Dh, Dh], got shape {tuple(r_z.shape)}")
    H, Dh, _ = r_z.shape
    if w_in.dim() != 3 or w_in.shape[-1] != 4 * H * Dh:
        raise ValueError(f"w_in {tuple(w_in.shape)} is not [B, S, 4 H Dh] = [B, S, {4 * H * Dh}]")
    B, S, _ = w_in.shape
    for name, t in (("r_i", r_i), ("r_f", r_f), ("r_o", r_o)):
        if tuple(t.shape) != (H, Dh, Dh) or t.dtype != r_z.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match r_z")
    for name, t in (("c", c), ("n", n), ("h", h), ("m", m)):
        if tuple(t.shape) != (B, H, Dh):
            raise ValueError(f"{name} {tuple(t.shape)} is not {(B, H, Dh)}")
    if S < 1:
        raise ValueError("the scan needs at least one step")
    _check_head_dim(Dh)
    _check_cuda((("w_in", w_in), ("r_z", r_z), ("r_i", r_i), ("r_f", r_f), ("r_o", r_o),
                 ("c", c), ("n", n), ("h", h), ("m", m)))
    if w_in.dtype != torch.float32:
        raise TypeError(f"w_in is {w_in.dtype}; the kernel takes float32")
    if r_z.dtype not in STATE_DTYPES:
        raise TypeError(f"r_z is {r_z.dtype}; the kernel takes float32 or bfloat16")
    _check_state((("c", c), ("n", n), ("h", h), ("m", m)), c.dtype)


def mlstm_scan_cuda(q, k, v, i_raw, f_raw, C, n, m):
    """-> (h f32 [B, S, H, Dh], (C, n, m) updated in place), one launch;
    see kernels.ref.mlstm_scan_ref."""
    check_mlstm_inputs(q, k, v, i_raw, f_raw, C, n, m)
    B, S, H, Dh = q.shape
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    h = torch.empty((B, S, H, Dh), dtype=torch.float32, device=q.device)
    # the launch's own count of each head's finished CTAs (the last one
    # writes n and m), from the allocator on the current stream, so that
    # launches on other streams never share it
    done = torch.zeros(B * H, dtype=torch.int32, device=q.device)
    lib = load_library("xlstm")
    code = lib.mlstm_scan_launch(
        B, S, H, Dh, int(C.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        i_raw.data_ptr(), *i_raw.stride(), f_raw.data_ptr(), *f_raw.stride(), C.data_ptr(),
        n.data_ptr(), m.data_ptr(), h.data_ptr(), done.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, code, "mlstm_scan")
    return h, (C, n, m)


def slstm_scan_cuda(w_in, r_z, r_i, r_f, r_o, c, n, h, m):
    """-> (h f32 [B, S, H, Dh], (c, n, h, m) updated in place), one launch;
    see kernels.ref.slstm_scan_ref."""
    check_slstm_inputs(w_in, r_z, r_i, r_f, r_o, c, n, h, m)
    B, S, _ = w_in.shape
    H, Dh, _ = r_z.shape
    w_in = w_in.contiguous()
    rs = [aligned16(r) for r in (r_z, r_i, r_f, r_o)]
    out = torch.empty((B, S, H, Dh), dtype=torch.float32, device=w_in.device)
    lib = load_library("xlstm")
    in_smem = lib.slstm_smem_gates(S, Dh, r_z.element_size())
    scratch = None                       # the kernel's chunk-major copy of the other gates
    if S > 1 and in_smem < 4:
        scratch = torch.empty(B * H * (4 - in_smem) * Dh * Dh, dtype=r_z.dtype,
                              device=w_in.device)
    code = lib.slstm_scan_launch(
        B, S, H, Dh, int(r_z.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
        w_in.data_ptr(), *(r.data_ptr() for r in rs), c.data_ptr(), n.data_ptr(),
        h.data_ptr(), m.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(w_in.device).cuda_stream)
    check_launch(lib, code, "slstm_scan")
    return out, (c, n, h, m)


# ---------------------------------------------------------------------------
# seeded inputs, shared by the card tests and chip_smoke.py
# ---------------------------------------------------------------------------

GATE_RANGE = 20.0       # |i_raw|, |f_raw| up to this: the stabiliser m switches branch


def mlstm_case(B: int, S: int, H: int, Dh: int, *, state_dtype=torch.float32, seed: int = 0,
               zero_state: bool = False, device="cpu"):
    """(q, k, v, i_raw, f_raw, C, n, m) for ``mlstm_scan``, drawn on
    ``device`` from a generator seeded with ``seed``: q, k, v standard
    normal, the gates uniform in [-GATE_RANGE, GATE_RANGE], the state
    standard normal (or zero) in ``state_dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    q, k, v = (torch.randn((B, S, H, Dh), **f32) for _ in range(3))
    i_raw, f_raw = ((torch.rand((B, S, H), **f32) * 2 - 1) * GATE_RANGE for _ in range(2))
    state = [(torch.zeros(shape, dtype=torch.float32, device=device) if zero_state
              else torch.randn(shape, **f32)).to(state_dtype)
             for shape in ((B, H, Dh, Dh), (B, H, Dh), (B, H))]
    return (q, k, v, i_raw, f_raw, *state)


def slstm_case(B: int, S: int, H: int, Dh: int, *, state_dtype=torch.float32,
               r_dtype=None, seed: int = 0, device="cpu"):
    """(w_in, r_z, r_i, r_f, r_o, c, n, h, m) for ``slstm_scan``, drawn on
    ``device`` from a generator seeded with ``seed``: the z and o
    pre-activations standard normal, the i and f ones uniform in
    [-GATE_RANGE, GATE_RANGE], r_* normal / sqrt(Dh) in ``r_dtype``
    (default ``state_dtype``), the state c, m standard normal, n uniform in
    [0.5, 2], h uniform in [-1, 1] in ``state_dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    d = H * Dh
    w_in = torch.randn((B, S, 4 * d), **f32)
    w_in[..., d:3 * d] = (torch.rand((B, S, 2 * d), **f32) * 2 - 1) * GATE_RANGE
    rs = [(torch.randn((H, Dh, Dh), **f32) * Dh ** -0.5).to(r_dtype or state_dtype)
          for _ in range(4)]
    shape = (B, H, Dh)
    state = [torch.randn(shape, **f32), torch.rand(shape, **f32) * 1.5 + 0.5,
             torch.rand(shape, **f32) * 2 - 1, torch.randn(shape, **f32)]
    return (w_in, *rs, *(s.to(state_dtype) for s in state))


def mlstm_condition(q, k, v, i_raw, f_raw, C, n, m) -> torch.Tensor:
    """kappa f32 [B, S, H] for ``mlstm_scan``'s arguments (read, not
    changed; v and C play no part): at each step, sum_j |n_j q_j| / denom, the factor by
    which a rounding in the dot n . q grows in h = C q / denom (denom =
    max(|n . q|, exp(-m)) + 1e-6).  Two f32 evaluations that sum n . q in
    different orders part in h by up to ~eps * kappa * |h|: where n . q
    nearly cancels, h is large and has few correct digits in any order."""
    Dh = q.shape[-1]
    sqrt_dh = torch.sqrt(torch.tensor(float(Dh), dtype=torch.float32, device=q.device))
    nf, mf = n.float(), m.float()
    out = []
    for t in range(q.shape[1]):
        f_log = torch.nn.functional.logsigmoid(f_raw[:, t])
        m_new = torch.maximum(f_log + mf, i_raw[:, t])
        nf = (torch.exp(f_log + mf - m_new)[..., None] * nf
              + torch.exp(i_raw[:, t] - m_new)[..., None] * (k[:, t] / sqrt_dh))
        nq = (nf * q[:, t]).sum(-1)
        denom = torch.maximum(nq.abs(), torch.exp(-m_new)) + 1e-6
        out.append((nf * q[:, t]).abs().sum(-1) / denom)
        mf = m_new
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# a kernel's outputs against its plain version's, shared by the card tests
# and chip_smoke.py
# ---------------------------------------------------------------------------

SCAN_TOL = 1e-5         # of each output's scale: f32 sums in another order


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| beyond SCAN_TOL of want's scale (what the
    f32 sums' order may part before the rounding, which where an update
    nearly cancels is many ulps of the small result), in bf16 ulps at the
    larger magnitude of the two."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    excess = ((g - w).abs() - SCAN_TOL * w.abs().max()).clamp(min=0.0)
    return float((excess / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def compare_scan(names: str, h, state, want_h, want_state, kappa=None) -> dict:
    """A scan's h and state against the plain version's: h's max abs error,
    its scale, and the largest share of the allowed error it takes (SCAN_TOL
    of the scale, for the mLSTM plus SCAN_TOL * kappa * |h|, kappa from
    ``mlstm_condition``); each state leaf (named by ``names``) within
    SCAN_TOL of its scale in f32, within one bf16 ulp beyond that in bf16,
    and whether it is bit-identical; ``ok`` if every one holds."""
    err = (h.double() - want_h.double()).abs()
    scale = float(want_h.double().abs().max())
    allowed = SCAN_TOL * scale
    if kappa is not None:
        allowed = allowed + SCAN_TOL * kappa.double()[..., None] * want_h.double().abs()
    out = {"max_abs_err": float(err.max()), "scale": scale, "share": float((err / allowed).max()),
           "kappa_max": None if kappa is None else float(kappa.max()), "state": {}}
    ok = out["share"] <= 1.0
    for name, g, w in zip(names, state, want_state):
        same = "bit-identical" if bool(torch.equal(g, w)) else "not bit-identical"
        if g.dtype == torch.bfloat16:
            ulps = bf16_ulps(g, w)
            out["state"][name] = f"{ulps:.3g} ulp, {same}"
            ok &= ulps <= 1.0
        else:
            rel = float((g.double() - w.double()).abs().max() / (w.double().abs().max() + 1e-30))
            out["state"][name] = f"{rel:.3e} of scale, {same}"
            ok &= rel <= SCAN_TOL
    out["ok"] = bool(ok)
    return out
