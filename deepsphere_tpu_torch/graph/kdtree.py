"""k nearest neighbours exactly as the JAX package's sklearn search picks them.

The JAX package builds its kNN graphs with sklearn's
``NearestNeighbors(n_neighbors=k + 1)``, which on HEALPix pixel vectors
(3 features, ``k + 1 < n // 2``) searches a ``KDTree`` of leaf size 30,
depth first.  The port has no sklearn.  Its distances are sklearn's
(squared chord by the same sums, then ``sqrt``), so a row's neighbour set is
fixed wherever its k-th and (k+1)-th distances differ.  HEALPix's symmetries
make them tie exactly in a few rows, and there the pick follows the tree:

* the tree splits each node at its median along the coordinate of largest
  spread, ordering points by (coordinate, index), with libstdc++'s
  ``std::nth_element``, which leaves each half in an order of its own;
* the query visits the nearer child first and pushes every point of a leaf,
  in that order, into a max-heap of ``k + 1`` that refuses a distance equal
  to its largest.

:func:`knn` takes every row's candidates from ``scipy.spatial.cKDTree`` and
replays the tree, the partition and the heap for the tied rows alone.
"""

import numpy as np

LEAF_SIZE = 30  # sklearn's NearestNeighbors default


# ---------------------------------------------------------------------------
# libstdc++ std::nth_element on a list of distinct keys, in place
# ---------------------------------------------------------------------------


def _nth_element(v, first, nth, last):
    if first == last or nth == last:
        return
    depth = 2 * ((last - first).bit_length() - 1)
    while last - first > 3:
        if depth == 0:
            _heap_select(v, first, nth + 1, last)
            v[first], v[nth] = v[nth], v[first]
            return
        depth -= 1
        cut = _partition_pivot(v, first, last)
        if cut <= nth:
            first = cut
        else:
            last = cut
    v[first:last] = sorted(v[first:last])  # insertion sort of distinct keys


def _partition_pivot(v, first, last):
    a, b, c = first + 1, first + (last - first) // 2, last - 1
    if v[a] < v[b]:
        s = b if v[b] < v[c] else (c if v[a] < v[c] else a)
    elif v[a] < v[c]:
        s = a
    else:
        s = c if v[b] < v[c] else b
    v[first], v[s] = v[s], v[first]
    p, lo, hi = v[first], first + 1, last
    while True:
        while v[lo] < p:
            lo += 1
        hi -= 1
        while p < v[hi]:
            hi -= 1
        if not lo < hi:
            return lo
        v[lo], v[hi] = v[hi], v[lo]
        lo += 1


def _heap_select(v, first, middle, last):
    n = middle - first
    if n >= 2:
        parent = (n - 2) // 2
        while True:
            _adjust_heap(v, first, parent, n, v[first + parent])
            if parent == 0:
                break
            parent -= 1
    for i in range(middle, last):
        if v[i] < v[first]:
            value, v[i] = v[i], v[first]
            _adjust_heap(v, first, 0, n, value)


def _adjust_heap(v, first, hole, n, value):
    top = child = hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if v[first + child] < v[first + child - 1]:
            child -= 1
        v[first + hole] = v[first + child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        v[first + hole] = v[first + child - 1]
        hole = child - 1
    while hole > top and v[first + (hole - 1) // 2] < value:
        v[first + hole] = v[first + (hole - 1) // 2]
        hole = (hole - 1) // 2
    v[first + hole] = value


# ---------------------------------------------------------------------------
# sklearn's KDTree: build, and one row's depth-first query
# ---------------------------------------------------------------------------


def build_tree(data, leaf_size=LEAF_SIZE):
    """sklearn's ``KDTree(data, leaf_size)``: its point order and its nodes.

    :return: (idx_array (n,) int64, lower (n_nodes, d), upper (n_nodes, d),
        span (n_nodes, 2) int64 [start, end), is_leaf (n_nodes,) bool)
    """
    n, n_feat = data.shape
    n_levels = int(np.log2(max(1.0, (n - 1) / leaf_size)) + 1)
    n_nodes = 2 ** n_levels - 1
    ar = np.arange(n)
    order = [np.lexsort((ar, data[:, j])) for j in range(n_feat)]
    rank = []
    for o in order:
        r = np.empty(n, dtype=np.int64)
        r[o] = ar
        rank.append(r)
    idx = ar.copy()
    lower = np.empty((n_nodes, n_feat))
    upper = np.empty((n_nodes, n_feat))
    span = np.zeros((n_nodes, 2), dtype=np.int64)
    is_leaf = np.zeros(n_nodes, dtype=bool)
    stack = [(0, 0, n)]
    while stack:
        node, s, e = stack.pop()
        pts = data[idx[s:e]]
        lower[node], upper[node] = pts.min(axis=0), pts.max(axis=0)
        span[node] = s, e
        if 2 * node + 1 >= n_nodes or e - s < 2:
            is_leaf[node] = True
            continue
        dim = int(np.argmax(upper[node] - lower[node]))
        mid = (e - s) // 2
        v = rank[dim][idx[s:e]].tolist()
        _nth_element(v, 0, mid, e - s)
        idx[s:e] = order[dim][v]
        # children are built in any order: each owns its own span
        stack.append((2 * node + 2, s + mid, e))
        stack.append((2 * node + 1, s, s + mid))
    return idx, lower, upper, span, is_leaf


def _min_rdist(lower, upper, pt):
    r = 0.0
    for j in range(len(pt)):
        d_lo = float(lower[j]) - pt[j]
        d_hi = pt[j] - float(upper[j])
        d = (d_lo + abs(d_lo)) + (d_hi + abs(d_hi))
        r += (0.5 * d) ** 2.0
    return r


def _heap_push(vals, inds, val, i_val):
    if val >= vals[0]:
        return
    size, cur = len(vals), 0
    while True:
        left = 2 * cur + 1
        if left >= size:
            break
        if left + 1 >= size:
            if vals[left] > val:
                swap = left
            else:
                break
        elif vals[left] >= vals[left + 1]:
            if val < vals[left]:
                swap = left
            else:
                break
        elif val < vals[left + 1]:
            swap = left + 1
        else:
            break
        vals[cur], inds[cur] = vals[swap], inds[swap]
        cur = swap
    vals[cur], inds[cur] = val, i_val


def query_row(tree, data, i, k):
    """sklearn's depth-first ``KDTree.query`` of point ``i`` for its ``k``
    nearest (itself included): their indices, in the heap's final order."""
    idx, lower, upper, span, is_leaf = tree
    pt = [float(c) for c in data[i]]
    vals, inds = [np.inf] * k, [0] * k
    stack = [(0, _min_rdist(lower[0], upper[0], pt))]
    while stack:
        node, lb = stack.pop()
        if lb > vals[0]:
            continue
        if is_leaf[node]:
            members = idx[span[node, 0]:span[node, 1]]
            diff = data[members] - data[i]
            rd = diff[:, 0] * diff[:, 0]
            for j in range(1, data.shape[1]):
                rd = rd + diff[:, j] * diff[:, j]
            for p, r in zip(members.tolist(), rd.tolist()):
                _heap_push(vals, inds, r, p)
            continue
        c1, c2 = 2 * node + 1, 2 * node + 2
        lb1 = _min_rdist(lower[c1], upper[c1], pt)
        lb2 = _min_rdist(lower[c2], upper[c2], pt)
        # a stack: the child visited first goes on last
        if lb1 <= lb2:
            stack += [(c2, lb2), (c1, lb1)]
        else:
            stack += [(c1, lb1), (c2, lb2)]
    return np.asarray(inds, dtype=np.int64)


# ---------------------------------------------------------------------------
# the neighbour sets
# ---------------------------------------------------------------------------


def _sq_dist(data, i, j):
    diff = data[j] - data[i][:, None, :]
    rd = diff[..., 0] * diff[..., 0]
    for c in range(1, data.shape[1]):
        rd = rd + diff[..., c] * diff[..., c]
    return rd


def candidates(data, k, margin=8, slack=1e-9, tree=None):
    """Every point's nearest ``k`` (itself included) and some past them:
    ``scipy.spatial.cKDTree`` candidates, widened until each row's last one
    lies more than ``slack`` beyond its k-th, so that no point tied with the
    k-th is missing.

    :return: (chord distances (n, m) float64, indices (n, m) int64), m > k
        unless m = n, sorted by cKDTree
    """
    from scipy.spatial import cKDTree

    n = data.shape[0]
    tree = cKDTree(data) if tree is None else tree
    while True:
        kq = min(k + margin, n)
        d, idx = tree.query(data, k=kq)
        d, idx = d.reshape(n, kq), idx.reshape(n, kq).astype(np.int64)
        if kq == n or np.all(d[:, -1] > d[:, k - 1] + slack):
            return d, idx
        margin = max(2 * margin, 8)


def knn(data, k):
    """The ``k`` nearest other points of every point, as the JAX package's
    ``NearestNeighbors(n_neighbors=k + 1).fit(data).kneighbors(data)``
    picks them, self dropped.

    :return: (distances (n, k) float64, indices (n, k) int64), each row
        sorted by (distance, index); ``n_tied``, the rows whose pick the
        tree replay settled
    """
    data = np.ascontiguousarray(data, dtype=np.float64)
    n = data.shape[0]
    _, cand = candidates(data, k + 1)
    rd = _sq_dist(data, np.arange(n), cand)
    order = np.lexsort((cand, rd), axis=1)
    rd, cand = np.take_along_axis(rd, order, 1), np.take_along_axis(
        cand, order, 1)
    keep = cand[:, :k + 1].copy()
    tied = np.flatnonzero(rd[:, k] == rd[:, k + 1]) if cand.shape[1] > k + 1 \
        else np.zeros(0, dtype=np.int64)
    if tied.size:
        tree = build_tree(data)
        for i in tied:
            keep[i] = query_row(tree, data, int(i), k + 1)
    rd = _sq_dist(data, np.arange(n), keep)
    order = np.lexsort((keep, rd), axis=1)[:, 1:]  # self first, dropped
    return (np.sqrt(np.take_along_axis(rd, order, 1)),
            np.take_along_axis(keep, order, 1), int(tied.size))
