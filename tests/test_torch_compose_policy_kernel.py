"""The policy kernels (B7) on the CPU: their plain versions against a NumPy
oracle and the reference's jax executor, an emulation of the retention
pass's block decomposition, the retention index, and the wrappers'
dispatch.

The refresh-aware kernels do their refresh work once per distinct
retention.  ``csrc/compose_policy.cu``'s retention pass cuts the
address-sorted lifetimes into ranges of ``threads * per_thread`` (one block
each) and each range into chunks of ``per_thread`` (one thread each); a
block walks every retention over its range.  A thread walks its chunk in
order and writes the refresh sum of every address whose lifetimes start and
end in it; an address that crosses chunks is carried by a block-wide scan
of transfers ``(pass, add)`` (the open refresh sum leaving a chunk is
``pass ? in + add : add``) and written where it ends, unless it entered the
range from before: then the range leaves it as its head summary, and the
address open at its end as its tail summary.  The join walks the ranges'
summaries the same way, one block per retention, a run of ranges per
thread with a scan between runs.  ``emulate_retention`` does all of that in
plain Python floats (each operation rounded as the kernel rounds it) at
small sizes, and is held exactly against ``policy_retention_plain`` on both
skews — a few addresses over every range, and one lifetime per address —
and on segments at the range and chunk lengths; the decision per address
on its sums gives the plain version's pick counts.  It is the only CPU
check of the join: change the kernel's decomposition and this emulation
together.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compose_policy import kernel as k
from repro_torch.kernels.compose_policy import ops

F64 = torch.float64


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _trace(seg_len, seed, boundary_rets=()):
    """Address-sorted lifetimes (seconds), integer reads and bits, int32
    segment ids, per-address sums, and the value-sorted side."""
    rng = np.random.RandomState(seed)
    seg_len = np.asarray(seg_len, np.int64)
    L = int(seg_len.sum())
    lt = rng.lognormal(np.log(2e-6), 2.0, L)
    if boundary_rets:
        pick = rng.rand(L) < 0.5
        kk = rng.randint(1, 9, L).astype(np.float64)
        rets = np.asarray(boundary_rets)[rng.randint(0, len(boundary_rets),
                                                     L)]
        lt[pick] = (kk * rets)[pick]
    reads = rng.poisson(3.0, L).astype(np.float64)
    bits = np.where(rng.rand(L) < 0.8, 256.0, 1024.0)
    seg = np.repeat(np.arange(len(seg_len), dtype=np.int32), seg_len)
    starts = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
    rb = reads * bits
    order = np.argsort(lt, kind="stable")
    return {
        "lt": lt, "reads": reads, "bits": bits, "rb": rb, "seg": seg,
        "starts": starts, "abits": np.add.reduceat(bits, starts),
        "arbits": np.add.reduceat(rb, starts),
        "lt_sorted": lt[order],
        "pb": np.concatenate([[0.0], np.cumsum(bits[order])]),
        "prb": np.concatenate([[0.0], np.cumsum(rb[order])]),
        "maxlt": np.sort(np.maximum.reduceat(lt, starts))}


def _candidates(C, D, seed, rets=()):
    """[C, D] candidates, NaN in every padded slot."""
    rng = np.random.RandomState(seed)
    n_dev = rng.randint(1, D + 1, C).astype(np.int32)
    n_dev[0] = D
    ret = np.full((C, D), np.nan)
    rf = np.full((C, D), np.nan)
    wf = np.full((C, D), np.nan)
    for c in range(C):
        for d in range(n_dev[c]):
            u = rng.rand()
            ret[c, d] = (np.inf if u < 0.15 else
                         rets[rng.randint(len(rets))] if u < 0.4 and rets
                         else rng.lognormal(np.log(2e-6), 2.0))
            rf[c, d], wf[c, d] = rng.uniform(0.5, 20.0, 2)
    return ret, rf, wf, n_dev


def _t(a, dtype=F64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _cands(ret, rf, wf, n_dev):
    return _t(ret), _t(rf), _t(wf), _t(n_dev, torch.int32)


def _pad(n_dev, D):
    return np.arange(D)[None, :] >= np.asarray(n_dev)[:, None]


def _index(ret, n_dev):
    """The retention index as tensors: ``(ret_u [R], ridx [C, D])``."""
    ret_u, ridx = ops.retention_index(ret, _pad(n_dev, ret.shape[1]))
    return _t(ret_u), _t(ridx, torch.int32)


def _addr_args(tr):
    return (_t(tr["lt"]), _t(tr["rb"]), _t(tr["bits"]),
            _t(tr["seg"], torch.int32), _t(tr["abits"]), _t(tr["arbits"]))


def _value_args(tr, grouped=True):
    return (_t(tr["lt_sorted"]), _t(tr["pb"]), _t(tr["prb"]),
            _t(tr["maxlt"] if grouped else np.zeros(0)))


def _plain_refresh_aware(ret, rf, wf, n_dev, tr):
    """The refresh-aware plain versions end to end: retention pass,
    grouped and ungrouped candidate passes, decision per address."""
    ret_u, ridx = _index(ret, n_dev)
    _, rf_t, wf_t, nd_t = _cands(ret, rf, wf, n_dev)
    lt, rb, bits, seg, abits, arbits = _addr_args(tr)
    rs, _ = k.policy_retention_plain(ret_u, lt, bits, seg, len(tr["abits"]))
    _, floor_part = k.policy_retention_plain(ret_u, lt, bits)
    part = k.policy_ra_grouped_plain(ret_u, ridx, rf_t, wf_t, nd_t, lt, rb,
                                     bits)
    counts = k.policy_ra_decide_plain(ridx, rf_t, wf_t, nd_t, rs, abits,
                                      arbits)
    upart, picks = k.policy_ra_ungrouped_plain(ret_u, ridx, rf_t, wf_t,
                                               nd_t, lt, rb, bits)
    return {"ret_u": ret_u.numpy(), "rs": rs, "floor": floor_part[:, 0],
            "energy": part[:, 0], "counts": counts, "uenergy": upart[:, 0],
            "picks": picks}


# ---------------------------------------------------------------------------
# NumPy oracle of the kernels (the reference's policy semantics)
# ---------------------------------------------------------------------------

def _energy(b, rb, rr, rf, wf):
    return wf * b + rf * rb + (rf + wf) * rr


def _refresh(lt, ret):
    return np.maximum(np.ceil(lt / ret) - 1.0, 0.0)


def _oracle(tr, ret, rf, wf, n_dev):
    """Per candidate: refresh-free energy and first-fit address counts,
    refresh-aware energy, per-address and per-lifetime argmin picks."""
    out = []
    for c in range(ret.shape[0]):
        nd = int(n_dev[c])
        r, f_r, f_w = ret[c, :nd], rf[c, :nd], wf[c, :nd]
        fits = tr["lt"][None, :] <= r[:, None]
        ff = np.where(fits.any(0), fits.argmax(0), nd - 1)
        e_rf = sum(_energy(tr["bits"][ff == d], tr["rb"][ff == d], 0.0,
                           f_r[d], f_w[d]).sum() for d in range(nd))
        afits = np.maximum.reduceat(tr["lt"], tr["starts"])[None, :] \
            <= r[:, None]
        ad = np.where(afits.any(0), afits.argmax(0), nd - 1)
        rr = _refresh(tr["lt"][None, :], r[:, None]) * tr["bits"]
        e = _energy(tr["bits"], tr["rb"], rr, f_r[:, None], f_w[:, None])
        per_addr = _energy(tr["abits"], tr["arbits"],
                           np.add.reduceat(rr, tr["starts"], axis=1),
                           f_r[:, None], f_w[:, None])
        out.append({"rf_energy": e_rf * 1e-15,
                    "rf_counts": np.bincount(ad, minlength=nd),
                    "ra_energy": e.min(0).sum(),
                    "ra_counts": np.bincount(per_addr.argmin(0),
                                             minlength=nd),
                    "picks": e.argmin(0)})
    return out


def _floor_oracle(tr, ret_u):
    """Algorithm 1's refresh bits per retention, as the reference's
    ``analyze_refresh`` sums them."""
    return np.array([(np.floor(tr["lt"] / r) * tr["bits"]).sum()
                     for r in ret_u])


ORACLE_CASES = [(0, 1, 3), (1, 4, 5), (2, 60, 2), (3, 500, 4), (4, 3, 1)]


def _oracle_case(seed, mean, D):
    rng = np.random.RandomState(seed)
    seg_len = rng.geometric(1.0 / mean, 300)
    exact = (2.0 ** -20, 3 * 2.0 ** -21)
    tr = _trace(seg_len, seed, boundary_rets=exact)
    return tr, _candidates(9, D, 100 + seed, rets=exact)


@pytest.mark.parametrize("seed,mean,D", ORACLE_CASES)
def test_plain_versions_match_the_numpy_oracle(seed, mean, D):
    tr, (ret, rf, wf, n_dev) = _oracle_case(seed, mean, D)
    cands = _cands(ret, rf, wf, n_dev)
    e_rf, counts_rf = k.policy_rf_plain(*cands, *_value_args(tr))
    got = _plain_refresh_aware(ret, rf, wf, n_dev, tr)
    assert got["floor"].tolist() == _floor_oracle(tr, got["ret_u"]).tolist()
    for c, want in enumerate(_oracle(tr, ret, rf, wf, n_dev)):
        nd = int(n_dev[c])
        assert counts_rf[c, :nd].tolist() == want["rf_counts"].tolist()
        assert counts_rf[c, nd:].tolist() == [0] * (D - nd)
        assert float(e_rf[c]) == pytest.approx(want["rf_energy"],
                                               rel=1e-12, abs=0)
        assert got["counts"][c, :nd].tolist() == want["ra_counts"].tolist()
        assert got["counts"][c, nd:].tolist() == [0] * (D - nd)
        assert float(got["energy"][c]) == pytest.approx(
            want["ra_energy"], rel=1e-12, abs=0)
        assert float(got["uenergy"][c]) == pytest.approx(
            want["ra_energy"], rel=1e-12, abs=0)
        assert got["picks"][c].tolist() == want["picks"].tolist()


@pytest.mark.parametrize("seed,mean,D", ORACLE_CASES)
def test_plain_versions_match_the_reference_jax_executor(seed, mean, D):
    """The reference's ``_ra_grouped`` and ``_ra_ungrouped`` (jax on the
    CPU) on the same inputs: counts and picks exactly, energy 1e-12."""
    from repro.compose import executor as ref_executor
    tr, (ret, rf, wf, n_dev) = _oracle_case(seed, mean, D)
    got = _plain_refresh_aware(ret, rf, wf, n_dev, tr)
    pad = _pad(n_dev, D)
    A = len(tr["abits"])
    with ref_executor.enable_x64():
        e_g, cnt = ref_executor._ra_grouped(
            ret, rf, wf, pad, tr["lt"], tr["reads"], tr["bits"], tr["seg"],
            np.int64(A), n_seg=A)
        e_u, ff = ref_executor._ra_ungrouped(ret, rf, wf, pad, tr["lt"],
                                             tr["reads"], tr["bits"])
    assert got["counts"].numpy().tolist() == np.asarray(cnt).astype(
        np.int64).tolist()
    assert got["picks"].numpy().tolist() == np.asarray(ff).tolist()
    np.testing.assert_allclose(got["energy"].numpy() * 1e-15, np.asarray(e_g),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got["uenergy"].numpy() * 1e-15,
                               np.asarray(e_u), rtol=1e-12, atol=0)


def test_refresh_counts_at_exact_retention_multiples():
    """``lt == k * ret`` needs k - 1 refreshes under the policy and k under
    Algorithm 1; one ulp more needs k under both, one ulp less k - 1 under
    both: the division is IEEE, never a reciprocal multiply, and both
    counts come from it."""
    ret = 3 * 2.0 ** -21
    at = [ret, 2 * ret, 5 * ret, 0.0]
    above = [np.nextafter(x, 1.0) for x in at[:3]]
    below = [np.nextafter(x, 0.0) for x in at[:3]]
    lt = torch.tensor(at + above + below, dtype=F64)
    r = torch.tensor(ret, dtype=F64)
    assert k.refresh_plain(lt, r).tolist() == \
        [0.0, 1.0, 4.0, 0.0] + [1.0, 2.0, 5.0] + [0.0, 1.0, 4.0]
    assert k.floor_plain(lt, r).tolist() == \
        [1.0, 2.0, 5.0, 0.0] + [1.0, 2.0, 5.0] + [0.0, 1.0, 4.0]
    inf = torch.tensor(np.inf, dtype=F64)
    assert k.refresh_plain(lt, inf).tolist() == [0.0] * 10
    assert k.floor_plain(lt, inf).tolist() == [0.0] * 10
    # the retention pass derives each from one division per lifetime: the
    # policy's counts with addresses, Algorithm 1's without
    bits = torch.full_like(lt, 256.0)
    seg = torch.arange(10, dtype=torch.int32)
    rs, none = k.policy_retention_plain(r[None], lt, bits, seg, 10)
    assert none is None
    assert (rs[0] / 256.0).tolist() == k.refresh_plain(lt, r).tolist()
    none, floor_part = k.policy_retention_plain(r[None], lt, bits)
    assert none is None
    assert floor_part[0, 0].item() == 256.0 * (
        1 + 2 + 5 + 1 + 2 + 5 + 0 + 1 + 4)


# ---------------------------------------------------------------------------
# the retention index
# ---------------------------------------------------------------------------

def _grid_retentions(**grid):
    """The [C, D] retention matrix of a device grid, cheapest device
    first, as the engine builds it, and its padding."""
    from repro_torch.compose import engine as ce
    from repro_torch.sweep import DeviceGrid
    devs = [sorted(c.devices, key=ce._device_sort_key)
            for c in DeviceGrid(**grid).candidates()]
    n_dev = np.array([len(d) for d in devs])
    ret = np.full((len(devs), n_dev.max()), -np.inf)
    for c, ds in enumerate(devs):
        ret[c, :len(ds)] = [d.retention_at(2.0e6) for d in ds]
    return ret, n_dev


def _index_cases():
    wide = _grid_retentions(
        mixes=(0.0, 0.5, 1.0), retention_scales=(0.5, 1.0, 2.0),
        area_scales=(0.5, 1.0, 2.0), energy_scales=(0.5, 1.0, 2.0))
    rng = np.random.RandomState(5)
    distinct = rng.lognormal(np.log(2e-6), 2.0, (6, 4))
    return {
        "duplicates_across_area_and_energy_scales": wide,
        "all_distinct": (distinct, np.array([4, 3, 4, 1, 2, 4])),
        "sram_only": (np.full((3, 2), np.inf), np.array([1, 2, 2])),
        "single_retention": (np.array([[np.inf, 1e-6], [1e-6, 1e-6],
                                       [1e-6, np.inf]]),
                             np.array([2, 2, 1])),
    }


@pytest.mark.parametrize("case", ["duplicates_across_area_and_energy_scales",
                                  "all_distinct", "sram_only",
                                  "single_retention"])
def test_retention_index_and_the_refresh_aware_passes(case):
    """The index names each distinct finite retention once, by bit
    pattern, and maps every real finite slot to it (-1 for SRAM's infinite
    retention and for padding); the plain passes on it equal the oracle."""
    ret, n_dev = _index_cases()[case]
    C, D = ret.shape
    pad = _pad(n_dev, D)
    ret = np.where(pad, np.nan, ret)
    ret_u, ridx = ops.retention_index(ret, pad)
    real = ~pad & np.isfinite(ret)
    keys = ret[real].view(np.int64)
    assert ret_u.view(np.int64).tolist() == sorted(set(keys.tolist()))
    assert ridx.dtype == np.int32 and (ridx[~real] == -1).all()
    assert ret_u[ridx[real]].view(np.int64).tolist() == keys.tolist()
    want_r = {"duplicates_across_area_and_energy_scales": None,
              "all_distinct": int(real.sum()), "sram_only": 0,
              "single_retention": 1}[case]
    if want_r is not None:
        assert len(ret_u) == want_r
    else:        # the retentions repeat across area and energy scales
        assert 0 < len(ret_u) <= int(real.sum()) // 9
    rng = np.random.RandomState(len(case))
    tr = _trace(rng.geometric(0.1, 120), 3)
    rf = np.where(pad, np.nan, rng.uniform(0.5, 20.0, (C, D)))
    wf = np.where(pad, np.nan, rng.uniform(0.5, 20.0, (C, D)))
    got = _plain_refresh_aware(ret, rf, wf, n_dev, tr)
    for c, want in enumerate(_oracle(tr, ret, rf, wf, n_dev)):
        nd = int(n_dev[c])
        assert got["counts"][c, :nd].tolist() == want["ra_counts"].tolist()
        assert got["picks"][c].tolist() == want["picks"].tolist()
        assert float(got["energy"][c]) == pytest.approx(
            want["ra_energy"], rel=1e-12, abs=0)
    assert got["floor"].tolist() == _floor_oracle(tr, ret_u).tolist()


def test_retention_groups_split_large_batches_without_changing_results():
    """More distinct retentions than a candidate pass takes: contiguous
    candidate slices of at most ``max_rows`` rows, renumbered locally, give
    the unsplit energies and picks exactly."""
    ret, rf, wf, n_dev = _candidates(40, 4, 21)
    tr = _trace(np.random.RandomState(2).geometric(0.2, 80), 4)
    pad = _pad(n_dev, 4)
    ret_u, ridx = ops.retention_index(ret, pad)
    assert len(ret_u) > 20
    groups = ops.retention_groups(ridx, len(ret_u), max_rows=16)
    assert len(groups) > 1 and groups[0][0] == 0 \
        and groups[-1][1] == 40
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    lt, rb, bits = _addr_args(tr)[:3]
    _, rf_t, wf_t, nd_t = _cands(ret, rf, wf, n_dev)
    whole_e, whole_p = k.policy_ra_ungrouped_plain(
        _t(ret_u), _t(ridx, torch.int32), rf_t, wf_t, nd_t, lt, rb, bits)
    for lo, hi, rows in groups:
        assert len(rows) <= 16
        u, r = ops._local_index(ret_u, ridx, lo, hi, rows)
        e, p = k.policy_ra_ungrouped_plain(_t(u), _t(r, torch.int32),
                                           rf_t[lo:hi], wf_t[lo:hi],
                                           nd_t[lo:hi], lt, rb, bits)
        assert torch.equal(e, whole_e[lo:hi]) and torch.equal(p,
                                                              whole_p[lo:hi])
    assert ops.retention_groups(ridx, len(ret_u)) == [(0, 40, None)]


# ---------------------------------------------------------------------------
# emulation of the retention pass's decomposition
# ---------------------------------------------------------------------------

def _compose(earlier, later):
    """Transfer composition: ``later`` applied after ``earlier``."""
    (p1, a1), (p2, a2) = earlier, later
    return (p1 and p2, [x + y for x, y in zip(a1, a2)] if p2 else list(a2))


def _block_scan(transfers, warp):
    """(exclusive, inclusive) per thread, in the kernel's order: a
    Hillis-Steele scan inside each warp, then the warps before in turn."""
    n = len(transfers)
    incl = list(transfers)
    for w0 in range(0, n, warp):
        lanes = list(range(w0, min(w0 + warp, n)))
        off = 1
        while off < warp:
            prev = {i: incl[i] for i in lanes}
            for i in lanes:
                if i - off >= w0:
                    incl[i] = _compose(prev[i - off], prev[i])
            off *= 2
    ident = (True, [0.0] * len(transfers[0][1]))
    excl_in_warp = [ident if i % warp == 0 else incl[i - 1]
                    for i in range(n)]
    out_ex, out_in = [], []
    for i in range(n):
        w = i // warp
        pre = ident
        for v in range(w):
            pre = _compose(pre, incl[min(v * warp + warp - 1, n - 1)])
        out_ex.append(_compose(pre, excl_in_warp[i]))
        out_in.append(_compose(pre, incl[i]))
    return out_ex, out_in


def _warp_tree(vals, warp):
    """Lane 0's sum after the kernel's shuffle-down tree."""
    vals = list(vals) + [0.0] * (-len(vals) % warp)
    off = warp // 2
    while off:
        vals = [vals[i] + (vals[i + off] if i + off < warp else 0.0)
                for i in range(warp)]
        off //= 2
    return vals[0]


def emulate_retention(ret_u, tr, threads, per_thread, warp, join_threads):
    """(rs [R, A], floor partials [R, n_ranges]) as the retention pass
    computes them with address groups (rs, through the join) and without
    (the floor partials), with ranges of ``threads * per_thread``; every
    per-address sum written exactly once."""
    lt, bits, seg = tr["lt"], tr["bits"], tr["seg"]
    L, A, R = len(lt), len(tr["abits"]), len(ret_u)
    RNG = threads * per_thread
    n_ranges = -(-L // RNG)
    rs = np.full((R, A), np.nan)
    floor_part = np.zeros((R, n_ranges))
    heads = np.full((R, n_ranges), np.nan)
    tails = np.full((R, n_ranges), np.nan)

    def store(r, a, v):
        assert np.isnan(rs[r, a]), "an address written twice"
        rs[r, a] = v

    for q in range(n_ranges):
        start = q * RNG
        n = min(RNG, L - start)
        e_prev = int(seg[start - 1]) if start > 0 else -1
        e_next = int(seg[start + n]) if start + n < L else -1
        range_in = e_prev == int(seg[start])
        last_t = (n - 1) // per_thread
        for r in range(R):
            t_ret = float(ret_u[r])
            transfers, info, f_acc = [], [], []
            for t in range(threads):
                base = t * per_thread
                my_n = max(0, min(per_thread, n - base))
                cin = cout = False
                first = last = -1
                if my_n:
                    first = int(seg[start + base])
                    last = int(seg[start + base + my_n - 1])
                    prev = e_prev if t == 0 else int(seg[start + base - 1])
                    nxt = (int(seg[start + base + my_n]) if base + my_n < n
                           else e_next)
                    cin, cout = prev == first, nxt == last
                through = cin and cout and first == last
                cur = head = 0.0
                first_piece, cur_seg, acc = True, first, 0.0
                for kk in range(my_n):
                    i = start + base + kk
                    if int(seg[i]) != cur_seg:
                        if first_piece and cin:
                            head = cur
                        else:
                            store(r, cur_seg, cur)
                        cur = 0.0
                        first_piece, cur_seg = False, int(seg[i])
                    qt = float(lt[i]) / t_ret
                    acc += math.floor(qt) * float(bits[i])
                    cur += max(math.ceil(qt) - 1.0, 0.0) * float(bits[i])
                p = True
                if my_n:
                    p = False
                    if first_piece and cin:
                        if through:
                            p = True
                        else:
                            head, cur = cur, 0.0
                    elif not cout:
                        store(r, cur_seg, cur)
                        cur = 0.0
                transfers.append((p, [cur]))
                info.append((my_n, cin, through, first, last, head))
                f_acc.append(acc)
            excl, incl = _block_scan(transfers, warp)
            for t, (my_n, cin, through, first, last, head) in \
                    enumerate(info):
                if my_n and cin and not through:
                    xp, xa = excl[t]
                    head = xa[0] + head
                    if xp and range_in:
                        heads[r, q] = head
                    else:
                        store(r, first, head)
            if e_next == info[last_t][4]:
                p, a = incl[last_t]
                (heads if p and range_in else tails)[r, q] = a[0]
            total = 0.0
            for w0 in range(0, threads, warp):
                total += _warp_tree(f_acc[w0:w0 + warp], warp)
            floor_part[r, q] = total
    # the join: a run of ranges per thread, a scan between runs
    per = -(-n_ranges // join_threads)

    def flags(q):
        s0, s1 = q * RNG, min(q * RNG + RNG, L)
        first, last = int(seg[s0]), int(seg[s1 - 1])
        cin = s0 > 0 and int(seg[s0 - 1]) == first
        cout = s1 < L and int(seg[s1]) == last
        return first, cin, cout, cin and cout and first == last

    for r in range(R):
        runs = [range(min(n_ranges, t * per),
                      min(n_ranges, min(n_ranges, t * per) + per))
                for t in range(join_threads)]
        transfers = []
        for run in runs:
            tr_ = (True, [0.0])
            for q in run:
                _, cin, cout, thr = flags(q)
                f = ((True, [heads[r, q]]) if thr else
                     (False, [tails[r, q]] if cout else [0.0]))
                tr_ = _compose(tr_, f)
            transfers.append(tr_)
        excl, _ = _block_scan(transfers, warp)
        for run, (_, open_) in zip(runs, excl):
            open_ = open_[0]
            for q in run:
                first, cin, cout, thr = flags(q)
                if thr:
                    open_ += heads[r, q]
                    continue
                if cin:
                    store(r, first, open_ + heads[r, q])
                open_ = tails[r, q] if cout else 0.0
    assert not np.isnan(rs).any(), "an address never written"
    return rs, floor_part


SIZES = [(4, 3, 2, 3), (8, 2, 4, 5), (3, 5, 2, 2), (6, 1, 4, 4)]


def _structures(threads, per_thread):
    R, K = threads * per_thread, per_thread
    return {
        "one_address": [R * 7 + 2],
        "one_lifetime_addresses": [1] * (R * 3 + 1),
        "few_addresses_over_many_ranges": [1, R * 5 + 1, 3, R * 4 - 1, 2],
        "segments_at_range_and_chunk_lengths":
            [R, K, 1, R, K - 1 or 1, K + 1, R + K, R - 1, R + 1, 2 * R] * 2,
        "random_mixed": list(np.random.RandomState(R).geometric(0.2, 60)),
    }


@pytest.mark.parametrize("threads,per_thread,warp,join_threads", SIZES)
@pytest.mark.parametrize("structure", ["one_address",
                                       "one_lifetime_addresses",
                                       "few_addresses_over_many_ranges",
                                       "segments_at_range_and_chunk_lengths",
                                       "random_mixed"])
def test_emulated_decomposition_matches_plain_exactly(
        threads, per_thread, warp, join_threads, structure):
    seg_len = _structures(threads, per_thread)[structure]
    exact = (2.0 ** -20, 5 * 2.0 ** -22)
    seed = threads * 100 + per_thread
    tr = _trace(seg_len, seed, boundary_rets=exact)
    D = 1 + seed % 4
    ret, rf, wf, n_dev = _candidates(4, D, seed, rets=exact)
    ret_u, ridx = _index(ret, n_dev)
    rs, floor_part = emulate_retention(ret_u.numpy(), tr, threads,
                                       per_thread, warp, join_threads)
    lt, _, bits, seg = _addr_args(tr)[:4]
    want_rs, _ = k.policy_retention_plain(ret_u, lt, bits, seg, len(seg_len))
    _, want_floor = k.policy_retention_plain(ret_u, lt, bits)
    # integer refresh counts times integer bits: every order is exact
    assert rs.tolist() == want_rs.numpy().tolist()
    assert floor_part.sum(axis=1).tolist() == want_floor[:, 0].tolist()
    _, rf_t, wf_t, nd_t = _cands(ret, rf, wf, n_dev)
    abits, arbits = _addr_args(tr)[4:]
    counts = k.policy_ra_decide_plain(ridx, rf_t, wf_t, nd_t, _t(rs), abits,
                                      arbits)
    assert counts.tolist() == k.policy_ra_decide_plain(
        ridx, rf_t, wf_t, nd_t, want_rs, abits, arbits).tolist()
    assert counts.sum() == len(seg_len) * 4
    for c, want in enumerate(_oracle(tr, ret, rf, wf, n_dev)):
        nd = int(n_dev[c])
        assert counts[c, :nd].tolist() == want["ra_counts"].tolist()


# ---------------------------------------------------------------------------
# the wrappers: dispatch, validation, no fallback
# ---------------------------------------------------------------------------

def _small():
    tr = _trace([3, 1, 4, 1, 5], 7)
    cands = _cands(*_candidates(3, 2, 8))
    return tr, cands


def _ra_calls(tr, cands):
    """Each refresh-aware wrapper once, on CPU tensors: (wrapper, plain,
    args)."""
    ret, rf, wf, n_dev = cands
    ret_u, ridx = _index(ret.numpy(), n_dev.numpy())
    lt, rb, bits, seg, abits, arbits = _addr_args(tr)
    rs, _ = k.policy_retention_plain(ret_u, lt, bits, seg, 5)
    cand = (ret_u, ridx, rf, wf, n_dev, lt, rb, bits)
    return [(k.policy_retention, k.policy_retention_plain,
             (ret_u, lt, bits, seg, 5)),
            (k.policy_retention, k.policy_retention_plain, (ret_u, lt, bits)),
            (k.policy_ra_grouped, k.policy_ra_grouped_plain, cand),
            (k.policy_ra_ungrouped, k.policy_ra_ungrouped_plain, cand),
            (k.policy_ra_decide, k.policy_ra_decide_plain,
             (ridx, rf, wf, n_dev, rs, abits, arbits))]


def test_cpu_tensors_take_the_plain_versions_without_a_compiler(
        monkeypatch):
    def no_compiler(*a, **kw):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_compiler)
    k._launcher.cache_clear()
    tr, cands = _small()
    calls = [(k.policy_rf, k.policy_rf_plain, (*cands, *_value_args(tr)))]
    calls += _ra_calls(tr, cands)
    launches = [fn.launches for fn in k.KERNELS]
    for fn, plain, args in calls:
        before = plain.calls
        got, want = fn(*args), plain(*args)
        assert plain.calls == before + 2
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        assert all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(got, want))
    assert [fn.launches for fn in k.KERNELS] == launches
    # the host-facing entry points finish on the host
    ret_u, ridx = ops.retention_index(cands[0].numpy(),
                                      _pad(cands[3].numpy(), 2))
    e, counts = ops.refresh_aware_grouped(cands, ret_u, ridx,
                                          *_addr_args(tr))
    assert e.shape == (3,) and counts.shape == (3, 2)
    part = k.policy_ra_grouped(_t(ret_u), _t(ridx, torch.int32),
                               *cands[1:], *_addr_args(tr)[:3])
    assert e.tolist() == (part.numpy().sum(axis=1) * 1e-15).tolist()
    assert ops.floor_refresh_bits(ret_u, *_addr_args(tr)[:3:2]).tolist() \
        == _floor_oracle(tr, ret_u).tolist()


def test_wrappers_reject_other_devices_and_bad_inputs(monkeypatch):
    tr, cands = _small()
    meta = tuple(x.to("meta") for x in cands)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k.policy_rf(*meta, *(x.to("meta") for x in _value_args(tr)))
    for fn, _, args in _ra_calls(tr, cands):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*(x.to("meta") if isinstance(x, torch.Tensor) else x
                 for x in args))
    ret, rf, wf, n_dev = cands
    with pytest.raises(TypeError, match="float64"):
        k.policy_rf(ret.float(), rf, wf, n_dev, *_value_args(tr))
    with pytest.raises(TypeError, match="int32"):
        k.policy_rf(ret, rf, wf, n_dev.long(), *_value_args(tr))
    with pytest.raises(ValueError, match="shape"):
        k.policy_rf(ret, rf[:, :1].contiguous(), wf, n_dev,
                    *_value_args(tr))
    ret_u, ridx = _index(ret.numpy(), n_dev.numpy())
    lt, rb, bits, seg, abits, arbits = _addr_args(tr)
    with pytest.raises(ValueError, match="contiguous"):
        k.policy_ra_ungrouped(ret_u, ridx.t().contiguous().t(), rf, wf,
                              n_dev, lt, rb, bits)
    with pytest.raises(TypeError, match="int32"):
        k.policy_ra_grouped(ret_u, ridx.long(), rf, wf, n_dev, lt, rb, bits)
    empty = torch.zeros(0, dtype=F64)
    with pytest.raises(ValueError, match="at least one lifetime"):
        k.policy_ra_ungrouped(ret_u, ridx, rf, wf, n_dev, empty, empty,
                              empty)
    with pytest.raises(ValueError, match="at least one address"):
        k.policy_retention(ret_u, lt, bits, seg, 0)
    with pytest.raises(ValueError, match="at least one address"):
        k.policy_ra_decide(ridx, rf, wf, n_dev, torch.zeros(1, 0, dtype=F64),
                           empty, empty)
    with pytest.raises(ValueError, match="trail"):
        ops.candidate_tensors(np.zeros((1, 3)), np.zeros((1, 3)),
                              np.zeros((1, 3)),
                              np.array([[False, True, False]]), "cpu")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: Path("/nonexistent") / f"{name}.so")
    k._launcher.cache_clear()
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k._launcher()
    k._launcher.cache_clear()


def test_candidate_tensors_count_the_real_devices():
    pad = np.array([[False, False, True], [False, True, True],
                    [False, False, False]])
    ret = np.where(pad, -np.inf, 1.0)
    got = ops.candidate_tensors(ret, ret, ret, pad, "cpu")
    assert got[3].dtype == torch.int32 and got[3].tolist() == [2, 1, 3]
    assert all(x.dtype == F64 and x.shape == (3, 3) for x in got[:3])
