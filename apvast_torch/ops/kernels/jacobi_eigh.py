"""K4: batched small symmetric eigensolver by cyclic parallel Jacobi.

Kernel: ``apvast_torch/csrc/jacobi_eigh.cu``, replacing
``apvast_tpu/ops/pallas/jacobi_eigh.py::jacobi_eigh``. The tracking GEVD
solver calls it once per outer step on its (2, k, k) Rayleigh-Ritz
matrices (k = 64 at the north star) with ``jacobi_sweeps=2``: far from
converged, so the result depends on the rotation order, and the port
keeps that order exactly: the padding to ``max(8, ceil8(n))`` slots, the
round-robin tournament schedule, the angle formula with its sign rule and
``1e-30`` guard, ``c = 1/sqrt(1 + t^2)``, the rotation-permutation matrix
of every round, and the sort-free ranking with pad slots keyed to +inf and
a first-index tie-break. Bound on the H100: latency (126 dependent rounds
at n = 64, on 2 of the card's 132 SMs; see the kernel's note).

Up to ``PAIR_SLOTS`` padded slots the card runs the pair-block form: A
rotated in place along the relabeled pair table (:func:`pair_table`), V's
rows in registers, one block barrier a round; it equals the template form
(:func:`jacobi_eigh_template`, for tests and tools) bit for bit. The plain
version serves every width, as the JAX function does. The card keeps A and
V in shared memory up to ``SHARED_SLOTS`` padded slots and in a workspace
(:func:`workspace`) up to ``MAX_SLOTS``; it raises above that.
"""

from __future__ import annotations

import numpy as np
import torch

from apvast_torch.ops.kernels import _batch, _build

PAIR_SLOTS = 64  # the widest matrix of the pair-block form (K4 and K7)
SHARED_SLOTS = 160  # A and V of a padded matrix sit in one block's shared memory
MAX_SLOTS = 512  # the card's bound: the global-memory form past SHARED_SLOTS


def tournament_schedule(n: int) -> np.ndarray:
    """src[slot] = slot whose occupant rotates into ``slot`` each round
    (the JAX function's schedule). Slots are paired (2i, 2i+1); slot 0 stays,
    the rest walk a ring: top row left-to-right, bottom row right-to-left.
    n - 1 rounds meet every index pair once and return to the identity
    arrangement, which is asserted here."""
    if n % 2:
        raise ValueError("n must be even")
    m = n // 2
    ring = [2 * i for i in range(1, m)] + [2 * i + 1 for i in range(m - 1, -1, -1)]
    src = np.arange(n)
    for p in range(len(ring)):
        src[ring[(p + 1) % len(ring)]] = ring[p]
    occ = np.arange(n)
    pairs = set()
    for _ in range(n - 1):
        pairs.update(
            (min(occ[2 * i], occ[2 * i + 1]), max(occ[2 * i], occ[2 * i + 1]))
            for i in range(m)
        )
        occ = occ[src]
    assert len(pairs) == n * (n - 1) // 2 and np.array_equal(occ, np.arange(n)), (
        "tournament schedule lost the covering property"
    )
    return src


def relabeled_pairs(npad: int) -> np.ndarray:
    """(npad - 1, npad // 2, 2): the slot pairs of every round of a sweep
    where the data stays in place and the slots are relabeled instead of
    moved. Round k rotates the physical pairs (pos_k(2i), pos_k(2i+1)), with
    pos_0 the identity and pos_{k+1}(c) = pos_k(src[c]): the rotations of
    the moving schedule, applied where its data would be. After npad - 1
    rounds pos is the identity again (asserted), so every sweep starts and
    ends on the same slots."""
    src = tournament_schedule(npad)
    pos = np.arange(npad)
    rounds = []
    for _ in range(npad - 1):
        rounds.append(pos.reshape(-1, 2).copy())
        pos = pos[src]
    assert np.array_equal(pos, np.arange(npad)), "relabeling did not return to the identity"
    return np.stack(rounds)


def bank_order(pairs: np.ndarray, banks: int = 32) -> np.ndarray:
    """(rounds, npad // 2) 0/1: which slot of each pair the card's pair-block
    form loads first (1: the second one). At npad = 2 * banks it is chosen
    so that the first slots of a round lie on distinct banks (slot mod
    banks), and with them the second: each bank holds two slots, so the
    pairs and banks form even cycles, and alternating along each cycle picks
    one slot of every bank. Below that every slot has a bank of its own and
    the order is 0."""
    rounds, half, _ = pairs.shape
    order = np.zeros((rounds, half), np.int64)
    if 2 * half != 2 * banks:
        return order
    for k in range(rounds):
        owner = {int(pairs[k, j, w]): (j, w) for j in range(half) for w in range(2)}
        done = np.zeros(half, bool)
        for start in range(half):
            j, w = start, 0
            while not done[j]:
                done[j], order[k, j] = True, w
                j, w = owner[int(pairs[k, j, w]) ^ banks]  # the other slot of that bank
                w = 1 - w  # ... is loaded second
        first = pairs[k, np.arange(half), order[k]] % banks
        assert len(set(first.tolist())) == half, "bank order is not conflict-free"
    return order


def export_table(npad: int) -> np.ndarray:
    """(npad - 1, words + npad // 2) int32, per round of the relabeled pair
    table (:func:`relabeled_pairs`): which of the round's 2 x 2 pair blocks
    hold the next round's rotation inputs, for the card's pipelined
    pair-block form. The next round's pair (P, Q) reads A[P, P] and A[Q, Q],
    which lie in this round's diagonal blocks, and A[P, Q], which lies in
    the block (pair of P, pair of Q) of this round, never a diagonal one
    (a pair meets once a sweep). Per round: ``words`` = ceil((npad/2)^2 /
    32) bit masks, bit t of the blocks t = i * npad/2 + j that are
    exported (the diagonal ones and the listed ones), then the distinct
    off-diagonal blocks, -1 past them."""
    pairs = relabeled_pairs(npad)
    rounds, half, _ = pairs.shape
    words = -(-half * half // 32)
    out = np.full((rounds, words + half), -1, np.int64)
    for k in range(rounds):
        owner = {int(slot): i for i in range(half) for slot in pairs[k, i]}
        listed: list[int] = []
        for p, q in pairs[(k + 1) % rounds]:
            i, j = owner[int(p)], owner[int(q)]
            assert i != j, "a pair met in two consecutive rounds"
            if i * half + j not in listed:
                listed.append(i * half + j)
        bits = np.zeros(words * 32, np.int64)
        bits[[i * half + i for i in range(half)] + listed] = 1
        out[k, :words] = (bits.reshape(words, 32) << np.arange(32)).sum(1)
        out[k, words:words + len(listed)] = listed
    return out.astype(np.uint32).view(np.int32)  # bit 31 as the sign


def padded_size(n: int) -> int:
    """Slots of the Jacobi iteration for an (n, n) matrix: a multiple of 8,
    at least 8 (the schedule depends on it)."""
    return max(8, -(-n // 8) * 8)


def _rank(w: torch.Tensor, n: int) -> torch.Tensor:
    """Ascending position of every slot: ``#{j : k_j < k_i} + #{j < i :
    k_j == k_i}`` with pad slots (index >= n) keyed to +inf."""
    npad = w.shape[-1]
    idx = torch.arange(npad, device=w.device)
    keyed = torch.where(idx < n, w, torch.full_like(w, float("inf")))
    ki, kj = keyed[:, :, None], keyed[:, None, :]
    tie = (kj == ki) & (idx[None, :] < idx[:, None])[None]
    return ((kj < ki) | tie).sum(-1)


def jacobi_eigh_plain(a: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense formula of the TPU kernel: every round builds the
    rotation-permutation matrix M and applies A <- M^T A M, V <- V M as
    batched matmuls. Shapes as :func:`jacobi_eigh`."""
    bz, n, _ = a.shape
    npad = padded_size(n)
    dev = a.device
    a = torch.nn.functional.pad(a.float(), (0, npad - n, 0, npad - n))
    src = torch.as_tensor(tournament_schedule(npad), device=dev)
    rows = torch.arange(npad, device=dev)[:, None]
    srcb = src[None, :]  # src(c) per column
    perm_d = (srcb == rows).float()
    perm_u = ((srcb == rows + 1) & (rows % 2 == 0)).float()
    perm_l = ((srcb == rows - 1) & (rows % 2 == 1)).float()
    even = (torch.arange(npad, device=dev) % 2 == 0).float()
    v = torch.eye(npad, device=dev).expand(bz, npad, npad)
    for _ in range(sweeps):
        for _ in range(npad - 1):
            diag = torch.diagonal(a, dim1=-2, dim2=-1)
            # a[2i, 2i+1] on the even slots, 0 on the odd ones.
            apq = a[:, 0::2, 1::2].diagonal(dim1=-2, dim2=-1)
            apq = torch.stack([apq, torch.zeros_like(apq)], -1).reshape(bz, npad)
            theta = torch.roll(diag, -1, dims=-1) - diag
            sg = torch.where(theta >= 0, 1.0, -1.0)
            denom = theta.abs() + torch.sqrt(theta * theta + 4.0 * apq * apq) + 1e-30
            t = 2.0 * apq * sg / denom
            c = torch.rsqrt(1.0 + t * t)
            s_e = t * c * even
            c_e = c * even
            s2 = (s_e + torch.roll(s_e, 1, dims=-1))[..., None]
            c2 = (c_e + torch.roll(c_e, 1, dims=-1))[..., None]
            m = perm_d * c2 + perm_u * s2 - perm_l * s2  # (bz, npad, npad)
            a = m.transpose(-1, -2) @ (a @ m)
            v = v @ m
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    perm = (_rank(w, n)[:, :, None] == torch.arange(n, device=dev)).float()
    # w (not keyed) is exactly zero at the pad slots, so the one-hot
    # contraction never multiplies inf by 0.
    w_out = torch.einsum("bi,bic->bc", w, perm)
    v_out = (v @ perm)[:, :n, :]
    return w_out, v_out


_schedules: dict[tuple[int, torch.device], torch.Tensor] = {}


def schedule(npad: int, device: torch.device) -> torch.Tensor:
    """The int32 tournament schedule of ``npad`` slots on ``device``, cached."""
    key = (npad, device)
    if key not in _schedules:
        _schedules[key] = torch.as_tensor(
            tournament_schedule(npad), dtype=torch.int32, device=device
        )
    return _schedules[key]


_pair_tables: dict[tuple[int, torch.device], torch.Tensor] = {}


def pair_table(npad: int, device: torch.device) -> torch.Tensor:
    """The relabeled pair table of ``npad`` slots (at most 256) on
    ``device``, cached: (npad - 1, npad // 2) int32, P | Q << 8 | order << 16
    per pair (:func:`relabeled_pairs`, :func:`bank_order`)."""
    key = (npad, device)
    if key not in _pair_tables:
        pairs = relabeled_pairs(npad)
        packed = pairs[..., 0] | pairs[..., 1] << 8 | bank_order(pairs) << 16
        _pair_tables[key] = torch.as_tensor(packed, dtype=torch.int32, device=device)
    return _pair_tables[key]


_export_tables: dict[tuple[int, torch.device], torch.Tensor] = {}


def exports(npad: int, device: torch.device) -> torch.Tensor:
    """:func:`export_table` of ``npad`` slots on ``device``, cached."""
    key = (npad, device)
    if key not in _export_tables:
        _export_tables[key] = torch.as_tensor(export_table(npad), device=device)
    return _export_tables[key]


def workspace(bz: int, npad: int, device: torch.device) -> torch.Tensor:
    """The card's buffers for ``bz`` matrices of ``npad`` slots: A, V and
    their second buffers in global memory past ``SHARED_SLOTS`` (empty
    below it); raises past ``MAX_SLOTS``."""
    if npad > MAX_SLOTS:
        raise ValueError(
            f"{npad} padded slots > {MAX_SLOTS}: the card's Jacobi bound (the CPU serves "
            "any width)"
        )
    size = 4 * bz * npad * npad if npad > SHARED_SLOTS else 0
    return torch.empty(size, dtype=torch.float32, device=device)


def jacobi_eigh(a: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a batch of small symmetric float32 matrices.

    Args:
        a: (B, n, n) symmetric; on the card n <= 512.
        sweeps: full Jacobi sweeps (n_pad - 1 rounds each).

    Returns:
        ``(w (B, n), v (B, n, n))``: eigenvalues ascending, eigenvectors in
        the columns of v, as ``torch.linalg.eigh`` orders them.
    """
    if _batch.via_op(a):
        return jacobi_eigh_op(a, sweeps)
    _build.check_input(a, "a", 3)
    bz, n, n2 = a.shape
    if n != n2 or n < 1:
        raise ValueError(f"a must be a batch of square matrices, got {tuple(a.shape)}")
    if sweeps < 0:
        raise ValueError("sweeps must be >= 0")
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps)
    return _launch(a, sweeps, template=False)


def jacobi_eigh_template(a: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`jacobi_eigh` through the card's template form at every width:
    the form the pair-block form is held to, bit for bit (tests and tools;
    no path calls it). A CUDA tensor only."""
    _build.check_input(a, "a", 3)
    if a.device.type != "cuda" or a.shape[1] != a.shape[2] or sweeps < 0:
        raise ValueError("jacobi_eigh_template takes a batch of square CUDA matrices")
    return _launch(a, sweeps, template=True)


def _launch(a: torch.Tensor, sweeps: int, template: bool) -> tuple[torch.Tensor, torch.Tensor]:
    bz, n, _ = a.shape
    npad = padded_size(n)
    work = workspace(bz, npad, a.device)
    w = torch.empty((bz, n), dtype=torch.float32, device=a.device)
    v = torch.empty((bz, n, n), dtype=torch.float32, device=a.device)
    if bz:
        src = schedule(npad, a.device)
        if template:
            _build.launch("jacobi_eigh", "jacobi_eigh_template_launch",
                          a, src, w, v, work, bz, n, npad, sweeps)
        else:
            pair_form = npad <= PAIR_SLOTS
            _build.launch("jacobi_eigh", "jacobi_eigh_launch", a, src,
                          pair_table(npad, a.device) if pair_form else None,
                          exports(npad, a.device) if pair_form else None,
                          w, v, work, bz, n, npad, sweeps)
        jacobi_eigh.launches += 1
    return w, v


jacobi_eigh.launches = 0
jacobi_eigh_op = _batch.fold(
    "jacobi_eigh", jacobi_eigh,
    fake=lambda a, sweeps: (a.new_empty(a.shape[:2]), a.new_empty(a.shape)),
)
