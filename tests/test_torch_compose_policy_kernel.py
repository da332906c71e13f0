"""The policy kernels (B7) on the CPU: their plain versions against a NumPy
oracle, an emulation of the grouped kernel's block decomposition, and the
wrappers' dispatch.

``csrc/compose_policy.cu``'s grouped pass cuts the address-sorted
lifetimes into ranges of ``threads * per_thread`` (one block each) and each
range into chunks of ``per_thread`` (one thread each).  A thread walks its
chunk in order and decides every address whose lifetimes start and end in
it; an address that crosses chunks is carried by a block-wide scan of
transfers ``(pass, add)`` (the open refresh sums leaving a chunk are
``pass ? in + add : add``) and decided where it ends, unless it entered the
range from before: then the range leaves it as its head summary, and the
address open at its end as its tail summary.  The join walks the ranges'
summaries the same way, a run of ranges per thread with a scan between
runs.  ``emulate_grouped`` does all of that in plain Python floats (each
operation rounded as the kernel rounds it) at small sizes, and is held
exactly (pick counts) against ``policy_ra_grouped_plain`` on both skews —
a few addresses over every range, and one lifetime per address — and on
segments at the range and chunk lengths.  It is the only CPU check of the
join: change the kernel's decomposition and this emulation together.
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


def _addr_args(tr):
    return (_t(tr["lt"]), _t(tr["rb"]), _t(tr["bits"]),
            _t(tr["seg"], torch.int32), _t(tr["abits"]), _t(tr["arbits"]))


def _value_args(tr, grouped=True):
    return (_t(tr["lt_sorted"]), _t(tr["pb"]), _t(tr["prb"]),
            _t(tr["maxlt"] if grouped else np.zeros(0)))


# ---------------------------------------------------------------------------
# NumPy oracle of the three kernels (the reference's policy semantics)
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


@pytest.mark.parametrize("seed,mean,D", [(0, 1, 3), (1, 4, 5), (2, 60, 2),
                                         (3, 500, 4), (4, 3, 1)])
def test_plain_versions_match_the_numpy_oracle(seed, mean, D):
    rng = np.random.RandomState(seed)
    seg_len = rng.geometric(1.0 / mean, 300)
    exact = (2.0 ** -20, 3 * 2.0 ** -21)
    tr = _trace(seg_len, seed, boundary_rets=exact)
    ret, rf, wf, n_dev = _candidates(9, D, 100 + seed, rets=exact)
    cands = _cands(ret, rf, wf, n_dev)
    e_rf, counts_rf = k.policy_rf_plain(*cands, *_value_args(tr))
    part, counts_ra = k.policy_ra_grouped_plain(*cands, *_addr_args(tr))
    upart, picks = k.policy_ra_ungrouped_plain(*cands, *_addr_args(tr)[:3])
    for c, want in enumerate(_oracle(tr, ret, rf, wf, n_dev)):
        nd = int(n_dev[c])
        assert counts_rf[c, :nd].tolist() == want["rf_counts"].tolist()
        assert counts_rf[c, nd:].tolist() == [0] * (D - nd)
        assert float(e_rf[c]) == pytest.approx(want["rf_energy"],
                                               rel=1e-12, abs=0)
        assert counts_ra[c, :nd].tolist() == want["ra_counts"].tolist()
        assert float(part[c].sum()) == pytest.approx(want["ra_energy"],
                                                     rel=1e-12, abs=0)
        assert float(upart[c].sum()) == pytest.approx(want["ra_energy"],
                                                      rel=1e-12, abs=0)
        assert picks[c].tolist() == want["picks"].tolist()


def test_refresh_counts_at_exact_retention_multiples():
    """``lt == k * ret`` needs k - 1 refreshes, one ulp more needs k: the
    division is IEEE, never a reciprocal multiply."""
    ret = 3 * 2.0 ** -21
    lt = torch.tensor([ret, 2 * ret, 5 * ret, np.nextafter(2 * ret, 1.0),
                       0.0], dtype=F64)
    got = k.refresh_plain(lt, torch.tensor(ret, dtype=F64))
    assert got.tolist() == [0.0, 1.0, 4.0, 2.0, 0.0]
    assert k.refresh_plain(lt, torch.tensor(np.inf, dtype=F64)).tolist() \
        == [0.0] * 5


# ---------------------------------------------------------------------------
# emulation of the grouped kernel's decomposition
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


def emulate_grouped(ret, rf, wf, n_dev, tr, threads, per_thread, warp,
                    join_threads):
    """(energy partials [C, n_ranges] fJ, pick counts [C, D]) as the
    kernel computes them, with ranges of ``threads * per_thread``."""
    lt, rb, bits, seg = tr["lt"], tr["rb"], tr["bits"], tr["seg"]
    abits, arbits = tr["abits"], tr["arbits"]
    L = len(lt)
    C, D = ret.shape
    R = threads * per_thread
    n_ranges = -(-L // R)
    part = np.zeros((C, n_ranges))
    counts = np.zeros((C, D), np.int64)
    heads = np.full((C, n_ranges, D), np.nan)
    tails = np.full((C, n_ranges, D), np.nan)

    def decide(c, a, rsum):
        nd = int(n_dev[c])
        vals = [_energy(float(abits[a]), float(arbits[a]), rsum[d],
                        float(rf[c, d]), float(wf[c, d])) for d in range(nd)]
        best = 0
        for d in range(1, nd):
            if vals[d] < vals[best]:
                best = d
        counts[c, best] += 1

    for r in range(n_ranges):
        start = r * R
        n = min(R, L - start)
        e_prev = int(seg[start - 1]) if start > 0 else -1
        e_next = int(seg[start + n]) if start + n < L else -1
        range_in = e_prev == int(seg[start])
        last_t = (n - 1) // per_thread
        for c in range(C):
            nd = int(n_dev[c])
            transfers, info, e_acc = [], [], []
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
                cur, head = [0.0] * D, [0.0] * D
                first_piece, cur_seg, acc = True, first, 0.0
                for kk in range(my_n):
                    i = start + base + kk
                    if int(seg[i]) != cur_seg:
                        if first_piece and cin:
                            head = list(cur)
                        else:
                            decide(c, cur_seg, cur)
                        cur = [0.0] * D
                        first_piece, cur_seg = False, int(seg[i])
                    emin = math.inf
                    for d in range(nd):
                        rr = max(math.ceil(lt[i] / ret[c, d]) - 1.0, 0.0) \
                            if ret[c, d] != math.inf else 0.0
                        rr = rr * float(bits[i])
                        emin = min(emin, _energy(float(bits[i]),
                                                 float(rb[i]), rr,
                                                 float(rf[c, d]),
                                                 float(wf[c, d])))
                        cur[d] += rr
                    acc += emin
                p = True
                if my_n:
                    p = False
                    if first_piece and cin:
                        if through:
                            p = True
                        else:
                            head, cur = list(cur), [0.0] * D
                    elif not cout:
                        decide(c, cur_seg, cur)
                        cur = [0.0] * D
                transfers.append((p, cur))
                info.append((my_n, cin, through, first, last, head))
                e_acc.append(acc)
            excl, incl = _block_scan(transfers, warp)
            for t, (my_n, cin, through, first, last, head) in \
                    enumerate(info):
                if my_n and cin and not through:
                    xp, xa = excl[t]
                    head = [x + h for x, h in zip(xa, head)]
                    if xp and range_in:
                        heads[c, r, :nd] = head[:nd]
                    else:
                        decide(c, first, head)
            if e_next == info[last_t][4]:
                p, a = incl[last_t]
                (heads if p and range_in else tails)[c, r, :nd] = a[:nd]
            part[c, r] = sum(e_acc)
    # the join: a run of ranges per thread, a scan between runs
    per = -(-n_ranges // join_threads)

    def flags(q):
        s0, s1 = q * R, min(q * R + R, L)
        first, last = int(seg[s0]), int(seg[s1 - 1])
        cin = s0 > 0 and int(seg[s0 - 1]) == first
        cout = s1 < L and int(seg[s1]) == last
        return first, cin, cout, cin and cout and first == last

    for c in range(C):
        runs = [range(min(n_ranges, t * per),
                      min(n_ranges, min(n_ranges, t * per) + per))
                for t in range(join_threads)]
        transfers = []
        for run in runs:
            tr_ = (True, [0.0] * D)
            for q in run:
                _, cin, cout, thr = flags(q)
                f = ((True, list(heads[c, q])) if thr else
                     (False, list(tails[c, q]) if cout else [0.0] * D))
                tr_ = _compose(tr_, f)
            transfers.append(tr_)
        excl, _ = _block_scan(transfers, warp)
        for run, (_, open_) in zip(runs, excl):
            open_ = list(open_)
            for q in run:
                first, cin, cout, thr = flags(q)
                if thr:
                    open_ = [x + h for x, h in zip(open_, heads[c, q])]
                    continue
                if cin:
                    open_ = [x + h for x, h in zip(open_, heads[c, q])]
                    decide(c, first, open_)
                open_ = list(tails[c, q]) if cout else [0.0] * D
    return part, counts


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
    part, counts = emulate_grouped(ret, rf, wf, n_dev, tr, threads,
                                   per_thread, warp, join_threads)
    want_part, want_counts = k.policy_ra_grouped_plain(
        *_cands(ret, rf, wf, n_dev), *_addr_args(tr))
    assert counts.tolist() == want_counts.tolist()
    assert counts.sum() == len(seg_len) * 4
    np.testing.assert_allclose(part.sum(axis=1), want_part[:, 0].numpy(),
                               rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the wrappers: dispatch, validation, no fallback
# ---------------------------------------------------------------------------

def _small():
    tr = _trace([3, 1, 4, 1, 5], 7)
    cands = _cands(*_candidates(3, 2, 8))
    return tr, cands


def test_cpu_tensors_take_the_plain_versions_without_a_compiler(
        monkeypatch):
    def no_compiler(*a, **kw):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_compiler)
    k._launcher.cache_clear()
    tr, cands = _small()
    launches = (k.policy_rf.launches, k.policy_ra_grouped.launches,
                k.policy_ra_ungrouped.launches)
    calls = (k.policy_rf_plain.calls, k.policy_ra_grouped_plain.calls,
             k.policy_ra_ungrouped_plain.calls)
    got = (k.policy_rf(*cands, *_value_args(tr)),
           k.policy_ra_grouped(*cands, *_addr_args(tr)),
           k.policy_ra_ungrouped(*cands, *_addr_args(tr)[:3]))
    want = (k.policy_rf_plain(*cands, *_value_args(tr)),
            k.policy_ra_grouped_plain(*cands, *_addr_args(tr)),
            k.policy_ra_ungrouped_plain(*cands, *_addr_args(tr)[:3]))
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    assert (k.policy_rf.launches, k.policy_ra_grouped.launches,
            k.policy_ra_ungrouped.launches) == launches
    assert (k.policy_rf_plain.calls, k.policy_ra_grouped_plain.calls,
            k.policy_ra_ungrouped_plain.calls) == tuple(c + 2 for c in calls)
    # the host-facing entry points finish on the host
    e, counts = ops.refresh_aware_grouped(cands, *_addr_args(tr))
    assert e.shape == (3,) and counts.shape == (3, 2)
    assert e.tolist() == (got[1][0].numpy().sum(axis=1) * 1e-15).tolist()


def test_wrappers_reject_other_devices_and_bad_inputs(monkeypatch):
    tr, cands = _small()
    meta = tuple(x.to("meta") for x in cands)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k.policy_rf(*meta, *(x.to("meta") for x in _value_args(tr)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k.policy_ra_grouped(*meta, *(x.to("meta") for x in _addr_args(tr)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k.policy_ra_ungrouped(*meta,
                              *(x.to("meta") for x in _addr_args(tr)[:3]))
    ret, rf, wf, n_dev = cands
    with pytest.raises(TypeError, match="float64"):
        k.policy_rf(ret.float(), rf, wf, n_dev, *_value_args(tr))
    with pytest.raises(TypeError, match="int32"):
        k.policy_rf(ret, rf, wf, n_dev.long(), *_value_args(tr))
    with pytest.raises(ValueError, match="shape"):
        k.policy_rf(ret, rf[:, :1].contiguous(), wf, n_dev,
                    *_value_args(tr))
    with pytest.raises(ValueError, match="contiguous"):
        k.policy_ra_ungrouped(ret.t().contiguous().t(), rf, wf, n_dev,
                              *_addr_args(tr)[:3])
    empty = torch.zeros(0, dtype=F64)
    with pytest.raises(ValueError, match="at least one lifetime"):
        k.policy_ra_ungrouped(*cands, empty, empty, empty)
    lt, rb, bits, seg, _, _ = _addr_args(tr)
    with pytest.raises(ValueError, match="at least one address"):
        k.policy_ra_grouped(*cands, lt, rb, bits, seg, empty, empty)
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
