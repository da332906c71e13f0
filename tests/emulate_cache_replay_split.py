"""A CPU emulation of the split cache replay (``csrc/cache_replay.cu``,
write-allocate): its three kernels' phases, one chunk, one tile after
another, on the compact set-sorted layout.

The chunk length ``S`` and the tile width are parameters here only; on the
card ``kernel.split_length`` picks ``S`` and a tile is one warp of 32
chunks.  Lists are Python lists of line addresses, most recent first; a
transfer is a list of 32 codes (``KCONST | bit`` or an incoming position);
the replay keeps the kernel's ways, int32 stamps and dirty/symbolic masks.
"""

KCONST = 0x40
INT_MAX = 2 ** 31 - 1


def set_of(v, n_sets):
    return (v >> 1) % n_sets


def combine(older, newer, ways):
    """newer's lines, then older's lines not among them, cut to ``ways``."""
    if len(newer) >= ways:
        return list(newer)
    return (list(newer) + [a for a in older if a not in newer])[:ways]


def then(f, t):
    """Transfer (or dirty codes) ``f`` followed by transfer ``t``."""
    return [c if c & KCONST else f[c] for c in t]


def init_state(stack, ways, width):
    tag = [stack[k] if k < len(stack) else -1 for k in range(width)]
    stamp = [-1 - k if k < len(stack) else
             (k - 2 * ways - 1 if k < ways else INT_MAX)
             for k in range(width)]
    return tag, stamp


def summarize(packed, offsets, n_sets, ways, S, tile):
    """Phase 1 (``split_summary_kernel``): each chunk's summary and flags,
    and each tile's folded list."""
    n = len(packed)
    chunks = -(-n // S)
    summary, head, complete = [], [], []
    for g in range(chunks):
        start, end = g * S, min(n, g * S + S)
        h = offsets[set_of(packed[start], n_sets)] == start
        piece = max(start, offsets[set_of(packed[end - 1], n_sets)])
        lst = []
        for i in range(end - 1, piece - 1, -1):
            if len(lst) == ways:
                break
            if packed[i] >> 1 not in lst:
                lst.append(packed[i] >> 1)
        summary.append(lst)
        head.append(h)
        complete.append(h or piece > start)
    tile_list, tile_complete = [], []
    for base in range(0, chunks, tile):
        cur, comp = [], False
        for g in range(base, min(chunks, base + tile)):
            cur = summary[g] if complete[g] else combine(cur, summary[g],
                                                         ways)
            comp |= complete[g]
        tile_list.append(cur)
        tile_complete.append(comp)
    return summary, head, complete, tile_list, tile_complete


def replay_chunk(packed, offsets, counts, n_sets, ways, width, start,
                 count, stack, out):
    """Phase 2's replay of one chunk from its incoming stack (one lane of
    ``split_replay_kernel``); returns (transfer, deferred {position: step})
    and writes the chunk's words into ``out``."""
    tag, stamp = init_state(stack, ways, width)
    dirty, sym, deferred = 0, (1 << len(stack)) - 1, {}
    s0 = set_of(packed[start], n_sets)
    next_set = min(count, offsets[s0] + counts[s0] - start)
    for j in range(count):
        v = packed[start + j]
        if j == next_set:                       # a set starts here
            tag, stamp = init_state([], ways, width)
            dirty = sym = 0
            next_set = min(count, j + counts[set_of(v, n_sets)])
        a, w = v >> 1, v & 1
        least = min(stamp)
        match = lru = 0
        victim = -1
        for k in range(width):
            match |= (tag[k] == a) << k
            if stamp[k] == least:
                lru |= 1 << k
                victim = tag[k]
        hit = match != 0
        way = match if hit else lru
        way_dirty = (dirty & way) != 0
        way_sym = (sym & way) != 0
        evicts = not hit and victim >= 0
        evict = -1 if hit else victim
        if evicts and way_sym:
            deferred[way.bit_length() - 1] = j
        evict_dirty = evicts and not way_sym and way_dirty
        for k in range(width):
            if way >> k & 1:
                tag[k], stamp[k] = a, j
        dirty = (dirty & ~way) | (way if (w or (way_dirty and hit)) else 0)
        if not (hit and not w):
            sym &= ~way
        out[start + j] = ((evict + 1) << 3) | (evict_dirty << 2) \
            | ((not hit) << 1) | hit
    xfer = [KCONST] * 32
    for k in range(width):
        if tag[k] < 0:
            continue
        rank = sum(1 for q in range(width)
                   if tag[q] >= 0 and stamp[q] > stamp[k])
        xfer[rank] = k if sym >> k & 1 else KCONST | (dirty >> k & 1)
    return xfer, deferred


def emulate_split(packed, offsets, counts, ways, S, tile=32, stats=None):
    """Result words of the split replay (write-allocate) of the set-sorted
    layout, in that layout; ``stats`` (a dict), if given, receives what the
    run saw: chunks, tiles, chunks whose incoming stack was not full, the
    longest walk back over tiles, deferred evictions and those resolved
    dirty."""
    packed, offsets, counts = (list(map(int, x)) for x in
                               (packed, offsets, counts))
    n, n_sets = len(packed), len(offsets)
    if n == 0:
        return []
    width = ways if ways in (8, 16) else 32
    chunks = -(-n // S)
    summary, head, complete, tile_list, tile_complete = summarize(
        packed, offsets, n_sets, ways, S, tile)
    out = [0] * n
    xfers, deferreds, tile_xfer = [], [], []
    st = {"chunks": chunks, "tiles": len(tile_list), "partial_stacks": 0,
          "longest_tile_walk": 0, "deferred": 0, "deferred_dirty": 0}
    for T, base in enumerate(range(0, chunks, tile)):
        # phase 2: the tile's incoming list, a walk back over tiles
        cur, walk = [], 0
        for t in range(T - 1, -1, -1):
            cur = combine(tile_list[t], cur, ways)
            walk += 1
            if tile_complete[t] or len(cur) >= ways:
                break
        st["longest_tile_walk"] = max(st["longest_tile_walk"], walk)
        for g in range(base, min(chunks, base + tile)):
            stack = [] if head[g] else cur
            if not head[g] and len(stack) < ways:
                st["partial_stacks"] += 1
            cur = summary[g] if complete[g] else combine(cur, summary[g],
                                                         ways)
            start = g * S
            xfer, deferred = replay_chunk(
                packed, offsets, counts, n_sets, ways, width, start,
                min(S, n - start), stack, out)
            xfers.append(xfer)
            deferreds.append(deferred)
        f = xfers[base]
        for g in range(base + 1, min(chunks, base + tile)):
            f = then(f, xfers[g])
        tile_xfer.append(f)
    for T, base in enumerate(range(0, chunks, tile)):
        # phase 3: the tile's incoming bits, a walk back over transfers
        f = [KCONST] * 32
        for t in range(T - 1, -1, -1):
            f = tile_xfer[t] if t == T - 1 else then(tile_xfer[t], f)
            if all(c & KCONST for c in f):
                break
        assert all(c & KCONST for c in f), "a symbolic bit reached tile 0"
        for g in range(base, min(chunks, base + tile)):
            for p, j in deferreds[g].items():
                st["deferred"] += 1
                if f[p] & 1:
                    out[g * S + j] |= 4
                    st["deferred_dirty"] += 1
            f = then(f, xfers[g])
    if stats is not None:
        stats.update(st)
    return out
