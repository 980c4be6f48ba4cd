"""The CUDA kernels K1 (csrc/csr_scatter.cu), K2 (csrc/csr_dedup.cu), K3
and K4 (both csrc/dense_matmul.cu) and K5 (csrc/dma_gather.cu) against
their plain PyTorch versions on the GPU, at the edge cases of their
layouts, and the gradients that run them; K4 on the batched 'dense'
evaluation's grouped products, the 'ell', 'ell2', 'dense' and 'onehot'
aggregations against 'segment', an 'auto' run past the csr cutover, and K1
on the rectangular blockings of a node-sharded rank (``parallel/halo.py``:
empty, 0- and 1-row halos, fewer and more columns than rows) with the halo
exchange on 2 gloo ranks of the card. Marked ``cuda``: they skip where no
GPU is found.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol = atol = 1e-5: the kernels sum float32 (K1 and K2
compensated, in shares or pieces of at most 64 items and ordered passes
over their parts) and the plain versions float64, in other orders;
K3 and K4 sum the same bf16-rounded operands as their plain versions.
K5 copies, so it is held bitwise.
Gradients through K3 and K4 are held at 1e-4: their small GEMMs are
float32 on the card and on the CPU, in other orders.
The bf16 forms of K1 and K2 (bf16 rows, float32 sums, one rounding a row)
are held at one bf16 unit in the last place, rtol 2^-7 with atol 1e-6:
their float32 sums and the plain versions' float64 ones can round to
neighbouring bf16 values. K3 with a bf16 h writes float32 and is held at
1e-5 like K3."""

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch.ops import csr

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _graph(n, e, skew, seed=0):
    rng = np.random.default_rng(seed)
    if skew:
        return ((n * rng.random(e) ** 3).astype(np.int64),
                (n * rng.random(e) ** 4).astype(np.int64))
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("n,e,f,bm,skew", [
    (100, 400, 8, 32, False),
    (257, 1000, 16, 64, False),      # n not a multiple of bm
    (64, 0, 4, 32, False),           # edgeless relation: all rows zero
    (2000, 9000, 7, 512, False),     # odd width: K1's scalar path
    (3000, 40000, 64, 1024, True),   # hub rows cut into pieces
    (5000, 60000, 100, 1024, True),  # F = 100: lanes loop over columns
])
@pytest.mark.parametrize("dedup", ["never", "always"])
def test_kernels_match_plain(dev, n, e, f, bm, skew, dedup):
    src, dst = _graph(n, e, skew)
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    for blk in csr.build_csr_blocking(src, dst, n, bm=bm, dedup=dedup):
        blk = blk.to(dev)
        is_dedup = isinstance(blk, csr.DedupCsrBlocking)
        kernel = csr.csr_dedup if is_dedup else csr.csr_scatter
        plain = csr.csr_dedup_plain if is_dedup else csr.csr_scatter_plain
        before = (csr.SCATTER_LAUNCHES, csr.DEDUP_LAUNCHES)
        got = kernel(blk, x)
        torch.cuda.synchronize()
        after = (csr.SCATTER_LAUNCHES, csr.DEDUP_LAUNCHES)
        assert after[is_dedup] == before[is_dedup] + 1
        torch.testing.assert_close(got, plain(blk, x), **TOL)


def _hub_graph(case):
    """One row of 60k edges (three passes of K2), rows spread over many
    pieces, or an edgeless relation."""
    if case == "hub_row":
        n = 3000
        src, dst = _graph(n, 70000, True, seed=2)
        src[:60000] = 11
    elif case == "many_pieces":
        n = 5000
        src, dst = _graph(n, 60000, True, seed=3)
    else:
        n = 300
        src = dst = np.zeros(0, dtype=np.int64)
    return n, src, dst


@pytest.mark.parametrize("f", [1, 4, 7, 64, 100])
@pytest.mark.parametrize("case", ["hub_row", "many_pieces", "edgeless"])
def test_dedup_kernel_cuts_hub_rows(dev, case, f):
    """K2 in both directions against its plain version, and a second launch
    on the same input bitwise-equal to the first (no atomics)."""
    n, src, dst = _hub_graph(case)
    if case == "edgeless":      # build_csr_blocking routes it to K1
        inv = np.ones(n, dtype=np.float32)
        blks = [csr._build_one_direction_dedup(src, dst, inv, n, n, pre)
                for pre in (False, True)]
    else:
        blks = csr.build_csr_blocking(src, dst, n, dedup="always")
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(f))
    for blk in blks:
        assert isinstance(blk, csr.DedupCsrBlocking)
        blk = blk.to(dev)
        before = csr.DEDUP_LAUNCHES
        got = csr.csr_dedup(blk, x)
        again = csr.csr_dedup(blk, x)
        torch.cuda.synchronize()
        assert csr.DEDUP_LAUNCHES == before + 2
        torch.testing.assert_close(got, csr.csr_dedup_plain(blk, x), **TOL)
        assert torch.equal(got, again)
        if case == "hub_row" and not blk.scale_is_pre:
            assert len(blk.level_pieces) - 1 == 3
        if case == "edgeless":
            assert not got.any()


def _k1_graph(case, share):
    """One row of 60k edges (about 940 shares of 64 items), rows of
    share - 1 edges that with their ends fill exactly one share each, or an
    edgeless relation."""
    if case == "hub_row":
        n = 3000
        src, dst = _graph(n, 70000, True, seed=2)
        src[:60000] = 11
    elif case == "one_share_rows":
        n = 2000
        src = np.repeat(np.arange(1000), share - 1)
        dst = np.random.default_rng(4).integers(0, n, len(src))
    else:
        n = 300
        src = dst = np.zeros(0, dtype=np.int64)
    return n, src, dst


@pytest.mark.parametrize("f", [1, 4, 7, 64, 100])
@pytest.mark.parametrize("case", ["hub_row", "one_share_rows", "edgeless"])
def test_scatter_kernel_balances_long_rows(dev, case, f):
    """K1 in both directions against its plain version, and a second launch
    on the same input bitwise-equal to the first (no atomics, the carries
    added in share order)."""
    _, share = csr.k1_layout(f, 4 if f % 4 == 0 else 1)
    n, src, dst = _k1_graph(case, share)
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(f))
    for blk in csr.build_csr_blocking(src, dst, n, dedup="never"):
        assert isinstance(blk, csr.CsrBlocking)
        blk = blk.to(dev)
        before = csr.SCATTER_LAUNCHES
        got = csr.csr_scatter(blk, x)
        again = csr.csr_scatter(blk, x)
        torch.cuda.synchronize()
        assert csr.SCATTER_LAUNCHES == before + 2
        torch.testing.assert_close(got, csr.csr_scatter_plain(blk, x), **TOL)
        assert torch.equal(got, again)
        if case == "edgeless":
            assert not got.any()


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    src, dst = _graph(100, 400, False)
    fwd, _ = csr.build_csr_blocking(src, dst, 100)
    x = torch.randn(100, 8, device=dev)
    with pytest.raises(ValueError, match="blocking"):
        csr.csr_scatter(fwd, x)                      # blocking on the CPU
    fwd = fwd.to(dev)
    with pytest.raises(TypeError):
        csr.csr_scatter(fwd, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        csr.csr_scatter(fwd, x.t().contiguous().t())


# ------------------------------------------------------------- K3 and K4
def _conv_inputs(n, e, f, hdim, dev, seed=0):
    """A random relation whose node 0 has no out-edge (an empty row of A),
    its operand on ``dev`` and numpy-seeded h, w, root, b; w and root are
    scaled by 1/sqrt(f) as glorot's are, so that the epilogue's float32
    sums of 2f terms stay inside the tolerance at any f."""
    from mpgnn_tpu_torch.ops import conv

    rng = np.random.default_rng(seed)
    src, dst = rng.integers(1, n, e), rng.integers(0, n, e)
    op = conv.build_dense_conv_operand(src, dst, n, dev)
    scale = (1.0, f ** -0.5, f ** -0.5, 1.0)
    t = [torch.from_numpy((c * rng.normal(size=s)).astype(np.float32)).to(dev)
         for c, s in zip(scale, ((n, f), (f, hdim), (f, hdim), (hdim,)))]
    return op, t


@pytest.mark.parametrize("n,e,f,hdim", [
    (100, 400, 8, 16),
    (257, 1500, 2, 64),       # n not a multiple of 8 (padded row stride)
    (1000, 4000, 1, 64),      # F = 1
    (1000, 4000, 64, 64),
    (5000, 5000, 2, 64),      # the shipped dataset's shapes, hop 0
    (5000, 5000, 64, 64),     # and hop 1
    (600, 3000, 200, 16),     # the widest tile (F padded to 256)
])
def test_dense_kernels_match_plain(dev, n, e, f, hdim):
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(n, e, f, hdim, dev)
    assert not op.a[0].any()
    before = (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES)
    out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    dh = conv.dense_matmul(op.a_t, h)
    torch.cuda.synchronize()
    assert (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
    want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
    torch.testing.assert_close(agg, want_agg, **TOL)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(dh, conv.dense_matmul_plain(op.a_t, h), **TOL)
    assert not agg[0].any()


@pytest.mark.parametrize("f", [1, 2, 64, 200])
@pytest.mark.parametrize("n", [257, 1000, 5000])
def test_matmul_kernel_splits_the_reduction(dev, n, f):
    """K4 against its plain version at N not a multiple of 8 (a_t's padded
    row stride) and reduction lengths that its splits do not divide, and a
    second launch bitwise-equal to the first."""
    from mpgnn_tpu_torch.ops import conv

    op, (h, _, _, _) = _conv_inputs(n, 4 * n, f, 8, dev, seed=n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = conv.matmul_splits(n, sms)
    assert splits > 1 and (n % splits or n % 64)
    before = conv.MATMUL_LAUNCHES
    got = conv.dense_matmul(op.a_t, h)
    again = conv.dense_matmul(op.a_t, h)
    torch.cuda.synchronize()
    assert conv.MATMUL_LAUNCHES == before + 2
    torch.testing.assert_close(got, conv.dense_matmul_plain(op.a_t, h), **TOL)
    assert torch.equal(got, again)
    if n % 8:
        with pytest.raises(ValueError, match="aligned"):
            conv.dense_matmul(op.a_t.contiguous(), h)


@pytest.mark.parametrize("f", [1, 2, 64, 200])
@pytest.mark.parametrize("n", [257, 1000, 5000])
def test_conv_kernel_splits_the_reduction(dev, n, f):
    """K3 (out and agg) against its plain version on the main loop's split
    reduction, where the splits do not divide it, and a second launch
    bitwise-equal to the first; an operand without the padded row stride is
    refused."""
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(n, 4 * n, f, 64, dev, seed=n + f)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = conv.matmul_splits(n, sms)
    assert splits > 1 and (n % splits or n % 64)
    before = conv.CONV_LAUNCHES
    out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    again_out, again_agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    torch.cuda.synchronize()
    assert conv.CONV_LAUNCHES == before + 2
    want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
    torch.testing.assert_close(agg, want_agg, **TOL)
    torch.testing.assert_close(out, want_out, **TOL)
    assert torch.equal(out, again_out) and torch.equal(agg, again_agg)
    if n % 8:
        with pytest.raises(ValueError, match="aligned"):
            conv.dense_conv_fwd(op.a.contiguous(), h, w, root, b)


@pytest.mark.parametrize("h_grad", [False, True])
def test_dense_conv_backward_launches_k4_only_for_dh(dev, h_grad):
    """Hop 0's input needs no gradient: K4 does not run there. The
    gradients equal the CPU path's (plain versions) on the same inputs."""
    from mpgnn_tpu_torch.ops import conv

    op, ts = _conv_inputs(300, 1200, 16, 64, dev, seed=1)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(300, 64)).astype(np.float32)).to(dev)
    grads = {}
    for where in ("cuda", "cpu"):
        o = op if where == "cuda" else conv.DenseConvOperand(
            op.a.cpu(), op.a_t.cpu(), op.num_rows)
        leaves = [t.detach().to(where, copy=True).requires_grad_(
            i > 0 or h_grad) for i, t in enumerate(ts)]
        before = conv.MATMUL_LAUNCHES
        (conv.dense_conv(o, *leaves) * g.to(where)).sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
            assert conv.MATMUL_LAUNCHES == before + h_grad
        grads[where] = [None if t.grad is None else t.grad.cpu()
                        for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dense_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(64, 200, 4, 8, dev)
    with pytest.raises(TypeError):
        conv.dense_conv_fwd(op.a.float(), h, w, root, b)
    with pytest.raises(ValueError, match="contiguous"):
        conv.dense_matmul(op.a_t, torch.randn(4, 64, device=dev).t())
    with pytest.raises(ValueError, match="tensors on"):
        conv.dense_conv_fwd(op.a, h.cpu(), w, root, b)
    with pytest.raises(ValueError, match="do not fit"):
        conv.dense_matmul(op.a_t, torch.randn(63, 64, device=dev))


# ------------------------------------------------------- csr backward
@pytest.mark.parametrize("dedup", ["never", "always"])
def test_csr_backward_runs_the_kernels(dev, dedup):
    """The gradient of csr_mean_aggregate runs K1 or K2 on the backward
    blocking and equals the CPU path's (plain versions)."""
    src, dst = _graph(3000, 40000, True, seed=3)
    fwd, bwd = csr.build_csr_blocking(src, dst, 3000, dedup=dedup)
    x = torch.randn(3000, 64, generator=torch.Generator().manual_seed(0))
    g = torch.randn(3000, 64, generator=torch.Generator().manual_seed(1))
    grads = []
    for where, f, b in (("cuda", fwd.to(dev), bwd.to(dev)), ("cpu", fwd, bwd)):
        xl = x.to(where).requires_grad_(True)
        before = (csr.CSR_BACKWARD_LAUNCHES, csr.SCATTER_LAUNCHES,
                  csr.DEDUP_LAUNCHES)
        (csr.csr_mean_aggregate(xl, f, b) * g.to(where)).sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
            k = 2 if dedup == "always" else 1
            after = (csr.CSR_BACKWARD_LAUNCHES, csr.SCATTER_LAUNCHES,
                     csr.DEDUP_LAUNCHES)
            assert after[0] == before[0] + 1
            assert after[k] == before[k] + 2          # forward and backward
        grads.append(xl.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], **TOL)


# ------------------------------------------------------- search sweeps
def _sweep_graph():
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph

    rng = np.random.default_rng(3)
    n = 400
    src = np.concatenate([rng.integers(0, 200, 1500), np.zeros(300, int)])
    dst = rng.integers(200, n, len(src))
    rel = rng.integers(0, 3, len(src))
    x = rng.random((n, 3)).astype(np.float32)
    tasks = [(0, [0, 1, 2], [[200, 201, 202], [203], [204, 205]],
              np.float32([1, 0, 1])),
             (1, [1], [[210, 211], [212]], np.float32([1, 0]))]
    return HeteroGraph(x, src, dst, rel, num_relations=3), tasks


def _sweeps(graph, tasks, device):
    from mpgnn_tpu_torch.config import ScorerConfig
    from mpgnn_tpu_torch.search import scoring

    labels = np.random.default_rng(0).random(graph.num_nodes).astype(
        np.float32)
    cfg = ScorerConfig(epochs_flat=30, epochs_bags=15, max_restarts=4)
    flat = scoring.score_relations_flat(graph, [0, 1, 2], labels, None, cfg,
                                        np.random.default_rng(1),
                                        device=device)
    bags = scoring.score_bag_tasks(graph, tasks, cfg,
                                   np.random.default_rng(2), device=device)
    return flat, bags


@pytest.mark.parametrize("form", ["ell", "seg"])
def test_search_sweeps_on_the_card(dev, monkeypatch, form):
    """The scoring sweeps on the card against the CPU (losses rtol 1e-5,
    atol 1e-6; weights and member values rtol 1e-4, atol 1e-5: the
    gradient's duplicate terms are summed in another order), with equal
    decisions, and a second run on the card bitwise equal to the first."""
    from mpgnn_tpu_torch.search import scoring

    monkeypatch.setattr(scoring, "_MEM_BUDGET_ENTRIES", 1_000_000)
    if form == "seg":
        monkeypatch.setattr(scoring, "_SEG_RATIO", 0)
    graph, tasks = _sweep_graph()
    card = _sweeps(graph, tasks, dev)
    again = _sweeps(graph, tasks, dev)
    cpu = _sweeps(graph, tasks, "cpu")
    for r, s in cpu[0].items():
        np.testing.assert_allclose(card[0][r].loss, s.loss, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(card[0][r].weights, s.weights, rtol=1e-4,
                                   atol=1e-5)
        assert card[0][r].loss == again[0][r].loss
        np.testing.assert_array_equal(card[0][r].weights, again[0][r].weights)
    for tid, scores in cpu[1].items():
        for r, s in scores.items():
            c, a = card[1][tid][r], again[1][tid][r]
            assert (c.degenerate, c.num_restarts) == (s.degenerate,
                                                      s.num_restarts)
            np.testing.assert_allclose(c.loss, s.loss, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(c.member_pred_max, s.member_pred_max,
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_array_equal(c.member_recorded,
                                          s.member_recorded)
            assert c.loss == a.loss
            np.testing.assert_array_equal(c.weights, a.weights)
            np.testing.assert_array_equal(c.attribution, a.attribution)


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("n,f,r,tiles,per", [
    (1000, 128, 1, 2, 256),         # the probe's layout, two tiles
    (777, 4, 1, 3, 100),            # 16-byte rows, short tiles
    (5000, 16, 64, 5, 7),           # runs of 4 KB, tiles of 7 runs
    (4000, 128, 64, 1, 20),         # 32 KB runs: a ring of 6 slots
    (300, 4, 16, 1, 5),             # fewer runs than ring slots
    (300, 400, 128, 3, 1),          # 200 KB runs: a ring of one slot
])
def test_dma_gather_matches_plain_bitwise(dev, n, f, r, tiles, per):
    from mpgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(n + f + r)
    starts = rng.integers(0, n - r + 1, (tiles, per)).astype(np.int32)
    starts[0, 0], starts[-1, -1] = n - r, 0   # the last row is gathered
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    s = torch.from_numpy(starts).to(dev)
    before = gather.DMA_GATHER_LAUNCHES
    got = gather.dma_gather(x, s, r)
    torch.cuda.synchronize()
    assert gather.DMA_GATHER_LAUNCHES == before + 1
    assert got.shape == (tiles * per * r, f)
    assert torch.equal(got, gather.dma_gather_plain(x, s, r))


def test_dma_gather_refuses_on_the_card(dev):
    from mpgnn_tpu_torch.ops import gather

    x = torch.zeros(10, 8, device=dev)
    with pytest.raises(IndexError):
        gather.dma_gather(x, torch.tensor([[9]], dtype=torch.int32,
                                          device=dev), 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather.dma_gather(torch.zeros(41, device=dev)[1:].reshape(10, 4),
                          torch.zeros(1, 1, dtype=torch.int32, device=dev), 1)


# ------------------------------------------------ batched evaluation (A7)
@pytest.mark.parametrize("f", [4, 64])
def test_k1_on_stacked_blockings_matches_plain(dev, f):
    """K1 on a block-diagonal stack of four relations' blockings, one of
    them with a 60k-edge row, forward and backward, against its plain
    version and against one launch a block."""
    n = 3000
    blocks = []
    for seed in range(4):
        src, dst = _graph(n, 20000, seed == 2, seed=seed)
        if seed == 3:
            src = np.concatenate([src, np.full(60000, 7)])
            dst = np.concatenate([dst, _graph(n, 60000, False, 9)[1]])
        blocks.append([b.to(dev) for b in csr.build_csr_blocking(
            src, dst, n, dedup="never")])
    x = torch.randn(4 * n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    for d in range(2):
        stacked = csr.stack_blockings(b[d] for b in blocks)
        got = csr.csr_scatter(stacked, x)
        each = torch.cat([csr.csr_scatter(b[d], x[i * n:(i + 1) * n])
                          for i, b in enumerate(blocks)])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, csr.csr_scatter_plain(stacked, x),
                                   **TOL)
        torch.testing.assert_close(got, each, **TOL)


def test_batched_evaluation_on_the_card(dev):
    """The batched evaluation (csr) on the card, K1, K2 and the csr
    backward launched, against the per-candidate one on the card: each
    candidate's validation log-probabilities within 1e-4 (float32 sums in
    other orders, stacked K1 and batched GEMMs, through 20 Adam steps; the
    CPU holds them within 1e-5) and validation F1 within 3e-2, as
    chip_smoke.py holds the search."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.train import batch_eval, build_hop_arrays, train_mpgnn
    from mpgnn_tpu_torch.train.loops import split_tensors

    rng = np.random.default_rng(0)
    n, e = 2500, 10000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.integers(0, 4, e)
    hub = rel == 3
    src[hub] = (n * rng.random(hub.sum()) ** 4).astype(np.int64)
    dst[hub] = (n * rng.random(hub.sum()) ** 6).astype(np.int64)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    labels = (x[:, 0] + 1.5 * rng.normal(size=n) > 0).astype(np.int64)
    graph = HeteroGraph(x, src, dst, rel, num_relations=4)
    split = split_nodes(labels)
    paths = [[0], [3], [1, 0], [3, 2], [0, 3], [2, 1, 0]]
    cfg = MPGNNConfig(epochs=20, hidden_dim=16)
    before = (csr.SCATTER_LAUNCHES, csr.DEDUP_LAUNCHES,
              csr.CSR_BACKWARD_LAUNCHES)
    got = batch_eval.evaluate_candidates(graph, paths, split, 2, cfg,
                                         backend="csr", device=dev)
    after = (csr.SCATTER_LAUNCHES, csr.DEDUP_LAUNCHES,
             csr.CSR_BACKWARD_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))
    xd = torch.from_numpy(x).to(dev)
    parts = split_tensors(split, dev)[:4]
    val = torch.from_numpy(split.val_idx).to(dev)
    for length in (1, 2, 3):
        chunk = [p for p in paths if len(p) == length]
        _, stack = batch_eval.train_chunk(graph, chunk, xd, parts, 2, cfg, 0,
                                          "csr")
        for p, model in zip(chunk, stack.split()):
            one = train_mpgnn(graph, [p], split, 2, cfg, backend="csr",
                              device=dev)
            assert abs(got[str(p)] - one.val_f1) <= 3e-2, p
            with torch.no_grad():
                ops = build_hop_arrays(graph, [p], "csr", dev)
                torch.testing.assert_close(model(xd, ops)[val],
                                           one.params(xd, ops)[val],
                                           rtol=0, atol=1e-4)


# ---------------------------------- ell, ell2, dense, onehot and 'auto'
@pytest.mark.parametrize("width", [64, 256, 320, 832])
@pytest.mark.parametrize("n", [1000, 5000])
def test_grouped_k4_matches_plain(dev, n, width):
    """K4 on the batched 'dense' evaluation's grouped operand [N, G * F]:
    one launch a slice of at most MAX_WIDTH columns (320 and 832 end in a
    short slice), over a and a_t, against its plain version; a second call
    bitwise-equal; and the grouped product of G candidates' [G, N, 64]
    features equal to G products of one."""
    from mpgnn_tpu_torch.ops import conv

    op, _ = _conv_inputs(n, 4 * n, 4, 8, dev, seed=width)
    x = torch.randn(n, width, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    slices = -(-width // conv.MAX_WIDTH)
    for a in (op.a, op.a_t):
        before = conv.MATMUL_LAUNCHES
        got, again = conv.dense_matmul(a, x), conv.dense_matmul(a, x)
        torch.cuda.synchronize()
        assert conv.MATMUL_LAUNCHES == before + 2 * slices
        torch.testing.assert_close(got, conv.dense_matmul_plain(a, x), **TOL)
        assert torch.equal(got, again)
    h = x.view(n, width // 64, 64).permute(1, 0, 2)
    grouped = conv.grouped_dense_aggregate(op, h)
    torch.testing.assert_close(
        grouped, torch.stack([conv.dense_matmul_plain(op.a, hg.contiguous())
                              for hg in h]), **TOL)


def _synthetic(n=3000, e=12000, rels=4, seed=0):
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph

    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 2 * n // 3, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    labels = (x[:, 0] + rng.normal(size=n) > 0).astype(np.int64)
    return HeteroGraph(x, src, dst, rng.integers(0, rels, e),
                       num_relations=rels), labels


@pytest.mark.parametrize("kind", ["ell", "ell2", "dense", "onehot"])
def test_new_kinds_match_segment_on_the_card(dev, kind):
    """Each new kind's aggregation, forward and input gradient, against
    'segment' on the card (float32 sums in other orders)."""
    from mpgnn_tpu_torch.models.mpgnn import hop_aggregate
    from mpgnn_tpu_torch.train.loops import relation_op

    graph, _ = _synthetic()
    n = graph.num_nodes
    g = torch.randn(n, 64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    outs = {}
    for k in ("segment", kind):
        h = torch.randn(n, 64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        h.requires_grad_(True)
        out = hop_aggregate(h, relation_op(graph, 1, k, dev), n)
        (out * g).sum().backward()
        outs[k] = (out.detach(), h.grad)
    for got, want in zip(outs[kind], outs["segment"]):
        torch.testing.assert_close(got, want, **TOL)


def test_auto_past_the_cutover_launches_k1(dev, monkeypatch):
    """train_mpgnn(backend='auto') on a graph past the csr cutover (and
    the dense budget) runs K1 and the csr backward."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.train import loops, train_mpgnn

    graph, labels = _synthetic()
    monkeypatch.setattr(loops, "AUTO_DENSE_BUDGET_BYTES", 0)
    monkeypatch.setattr(loops, "CSR_EDGE_CUTOVER",
                        int(graph.rel_counts[[1, 2]].max()))
    assert loops.resolve_backend("auto", graph, [[1, 2]],
                                 loops.auto_dense_budget_bytes(dev)) == "csr"
    before = (csr.SCATTER_LAUNCHES, csr.CSR_BACKWARD_LAUNCHES)
    train_mpgnn(graph, [[1, 2]], split_nodes(labels), 2,
                MPGNNConfig(epochs=3, hidden_dim=16), backend="auto",
                device=dev)
    torch.cuda.synchronize()
    assert csr.SCATTER_LAUNCHES > before[0]
    assert csr.CSR_BACKWARD_LAUNCHES > before[1]


def test_search_stages_share_each_operand(dev, monkeypatch):
    """The batched evaluation (keyed by its features' device, 'cuda:0')
    and the greedy stage (the caller's 'cuda') build each relation's
    blockings once."""
    from mpgnn_tpu_torch.config import MPGNNConfig, SearchConfig
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.search import evaluate_and_select
    from mpgnn_tpu_torch.train import loops

    graph, labels = _synthetic()
    built = []
    real = loops.relation_op
    monkeypatch.setattr(loops, "relation_op", lambda g, r, b, d: built.append(
        (r, b)) or real(g, r, b, d))
    cfg = SearchConfig(mpgnn=MPGNNConfig(epochs=2, hidden_dim=16))
    evaluate_and_select(graph, [[0], [1], [1, 0], [2, 0]],
                        split_nodes(labels), 2, cfg, graph.x, backend="csr",
                        device=torch.device("cuda"))
    assert sorted(built) == [(0, "csr"), (1, "csr"), (2, "csr")]


def test_batched_dense_evaluation_launches_k4(dev):
    """The batched 'dense' evaluation on the card launches K4 for every
    hop's grouped products, forward and backward, and its validation F1s
    lie within 8e-2 of the float32 dense per-candidate runs."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.ops import conv
    from mpgnn_tpu_torch.train import batch_eval, train_mpgnn

    graph, labels = _synthetic()
    split = split_nodes(labels)
    paths = [[0], [1], [1, 0], [2, 0], [3, 1, 0]]
    cfg = MPGNNConfig(epochs=10, hidden_dim=16)
    before = conv.MATMUL_LAUNCHES
    got = batch_eval.evaluate_candidates(graph, paths, split, 2, cfg,
                                         backend="dense", device=dev)
    torch.cuda.synchronize()
    # hop 0: one product a relation a group (2 + 2 + 1); after it, per
    # epoch forward and backward and the final forward: length 2 one
    # relation, length 3 two hops of one
    assert conv.MATMUL_LAUNCHES - before == 5 + 21 * (1 + 2)
    for p in paths:
        one = train_mpgnn(graph, [p], split, 2, cfg, backend="dense",
                          device=dev)
        assert abs(got[str(p)] - one.val_f1) <= 8e-2, p


# ------------------------------------------------------ the bf16 forms
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("f", [1, 3, 4, 8, 12, 16, 64, 65])
@pytest.mark.parametrize("dedup", ["never", "always"])
def test_bf16_forms_match_plain(dev, dedup, f):
    """K1 and K2 on bf16 rows: a 6,000-edge row cut across K1's shares
    (its carries and head slot), rows without edges, every load width
    (8, 4 and 1 values a lane), both directions; bitwise repeats."""
    rng = np.random.default_rng(3)
    n = 3000
    src = np.concatenate([rng.integers(0, n, 20000), np.full(6000, 7),
                          np.full(130, 11)])
    dst = rng.integers(0, n, len(src))
    src[src % 41 == 5] = 6
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(
        dev).bfloat16()
    before = (csr.SCATTER_BF16_LAUNCHES, csr.DEDUP_BF16_LAUNCHES)
    for blk in csr.build_csr_blocking(src, dst, n, dedup=dedup):
        blk = blk.to(dev)
        is_dedup = isinstance(blk, csr.DedupCsrBlocking)
        kernel = csr.csr_dedup if is_dedup else csr.csr_scatter
        plain = csr.csr_dedup_plain if is_dedup else csr.csr_scatter_plain
        got, again = kernel(blk, x), kernel(blk, x)
        want = plain(blk, x)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    after = (csr.SCATTER_BF16_LAUNCHES, csr.DEDUP_BF16_LAUNCHES)
    assert after[1 if dedup == "always" else 0] > before[
        1 if dedup == "always" else 0]


@pytest.mark.parametrize("dedup", ["never", "always"])
def test_bf16_csr_hop_gradient_on_the_card(dev, dedup):
    """A bf16 csr hop and its gradient through the bf16 forms, against the
    float32 kernels between two casts (the JAX package's route)."""
    rng = np.random.default_rng(4)
    n = 2000
    src, dst = rng.integers(0, n, 30000), rng.integers(0, n, 30000)
    fwd, bwd = (b.to(dev) for b in csr.build_csr_blocking(src, dst, n,
                                                          dedup=dedup))
    h = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(
        dev).bfloat16()
    g = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(
        dev).bfloat16()
    outs = []
    for cast in (False, True):
        hh = h.clone().requires_grad_()
        out = (csr._CsrMeanAggregate.apply(hh.float(), fwd, bwd).bfloat16()
               if cast else csr.csr_mean_aggregate(hh, fwd, bwd))
        out.backward(g)
        outs.append((out.detach().float(), hh.grad.float()))
    torch.testing.assert_close(outs[0][0], outs[1][0], **BF16_TOL)
    torch.testing.assert_close(outs[0][1], outs[1][1], **BF16_TOL)


@pytest.mark.parametrize("f", [1, 2, 64, 200])
@pytest.mark.parametrize("n", [257, 5000])
def test_conv_kernel_takes_a_bf16_h(dev, n, f):
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(n, 10 * n, f, 64, dev)
    h = h.bfloat16()
    before = conv.CONV_BF16H_LAUNCHES
    out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    again = conv.dense_conv_fwd(op.a, h, w, root, b)
    want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
    torch.cuda.synchronize()
    assert out.dtype == agg.dtype == torch.float32
    assert conv.CONV_BF16H_LAUNCHES == before + 2
    assert torch.equal(out, again[0]) and torch.equal(agg, again[1])
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(agg, want_agg, **TOL)


@pytest.mark.parametrize("bf16h", [False, True])
@pytest.mark.parametrize("f,hdim", [(300, 64), (256, 256), (512, 64),
                                    (64, 63)])
@pytest.mark.parametrize("n", [257, 5000])
def test_conv_kernel_takes_any_width(dev, n, f, hdim, bf16h):
    """K3 and its bf16-h form where the JAX kernel takes what the card's
    formerly refused: F past one main loop's 256 columns (300: a slice of
    44; 512: two full slices), F = H = 256 (past the former epilogue's
    shared memory) and H % 4 != 0 (one output column a thread); one launch
    each, against the plain version, a second launch bitwise the first."""
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(n, 10 * n, f, hdim, dev, seed=f)
    if bf16h:
        h = h.bfloat16()
    count = "CONV_BF16H_LAUNCHES" if bf16h else "CONV_LAUNCHES"
    before = getattr(conv, count)
    out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    again = conv.dense_conv_fwd(op.a, h, w, root, b)
    want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
    torch.cuda.synchronize()
    assert getattr(conv, count) == before + 2
    assert out.shape == (n, hdim) and agg.shape == (n, f)
    assert torch.equal(out, again[0]) and torch.equal(agg, again[1])
    torch.testing.assert_close(agg, want_agg, **TOL)
    torch.testing.assert_close(out, want_out, **TOL)


def test_wide_conv_backward_runs_k4_for_dh(dev):
    """At F = H = 256 the backward's dh goes through one K4 launch over
    a_t, and the four gradients equal float64 sums on the card's own ReLU
    mask (a CPU reference would flip the mask where K3's float32 output
    lies within rounding of 0, and move every gradient there): dh's K4 term
    within 1e-5 of the plain version on the operand the backward forms,
    the float32 GEMMs within 1e-4."""
    from mpgnn_tpu_torch.ops import conv

    op, ts = _conv_inputs(5000, 50000, 256, 256, dev, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(5000, 256)).astype(np.float32)).to(dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in ts]
    before = (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES)
    out = conv.dense_conv(op, *leaves)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
    h, w, root, b = ts
    _, agg = conv.dense_conv_plain(op.a, h, w, root, b)
    dz = torch.where(out.detach() > 0, g, torch.zeros_like(g))
    d = (dz @ w.t()).contiguous()
    want_dh = conv.dense_matmul_plain(op.a_t, d) + dz @ root.t()
    torch.testing.assert_close(leaves[0].grad, want_dh, **TOL)
    dz = dz.double()
    for got, want in ((leaves[1].grad, agg.double().t() @ dz),
                      (leaves[2].grad, h.double().t() @ dz),
                      (leaves[3].grad, dz.sum(0))):
        torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["csr", "pallas", "segment", "dense"])
def test_bf16_training_on_the_card(dev, backend):
    """``train_mpgnn`` in bf16 on the card against the same run on the
    CPU (the kernels' plain versions): the same first-step loss within
    1e-2 and float32 parameters; csr launches the bf16 forms of K1/K2,
    pallas K3's bf16-h form."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.ops import conv
    from mpgnn_tpu_torch.train import loops

    rng = np.random.default_rng(5)
    n = 1500
    g = HeteroGraph(rng.normal(size=(n, 8)).astype(np.float32),
                    rng.integers(0, n, 20000), rng.integers(0, n, 20000),
                    rng.integers(0, 3, 20000), num_relations=3)
    split = split_nodes(rng.integers(0, 2, n))
    cfg = MPGNNConfig(epochs=1, hidden_dim=16, dropout=0.0,
                      compute_dtype="bfloat16")
    def bf16_launches():
        return (csr.SCATTER_BF16_LAUNCHES + csr.DEDUP_BF16_LAUNCHES,
                conv.CONV_BF16H_LAUNCHES)

    before = bf16_launches()
    card = loops.train_mpgnn(g, [[0, 1]], split, 2, cfg, backend=backend)
    after = bf16_launches()
    host = loops.train_mpgnn(g, [[0, 1]], split, 2, cfg, backend=backend,
                             device="cpu")
    assert abs(card.final_loss - host.final_loss) <= 1e-2
    assert card.params.fc1.weight.dtype == torch.float32
    # csr: K1's or K2's bf16 form, as each direction routes
    assert (after[0] > before[0]) == (backend == "csr")
    assert (after[1] > before[1]) == (backend == "pallas")


def _planted_partition(parts):
    from mpgnn_tpu_torch.graph.generate import generate_synthetic_graph
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.graph.partition import PartitionedHeteroGraph

    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    pg = PartitionedHeteroGraph(g["node_features"].astype(np.float32),
                                g["src"], g["dst"], g["rel"], 4, parts,
                                labels=g["labels"])
    return pg, [list(g["metapath_relations"])], split_nodes(g["labels"])


def test_streaming_equals_resident_on_the_card(dev):
    """Clustered csr training with every group copied one visit ahead on
    a side stream (``resident=False``) gives bitwise the parameters of the
    run with every group on the card, dropout on; K1 runs in both."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train.stream import train_mpgnn_clustered

    pg, mp, split = _planted_partition(5)
    cfg = MPGNNConfig(epochs=8, hidden_dim=16)
    runs = []
    for resident in (True, False):
        before = csr.SCATTER_LAUNCHES
        rep = {}
        res = train_mpgnn_clustered(pg, mp, split, 2, cfg, backend="csr",
                                    resident=resident, report=rep)
        assert csr.SCATTER_LAUNCHES > before
        assert rep["resident"] is resident and rep["device_peak_bytes"] > 0
        runs.append(res)
    for a, b in zip(runs[0].params.parameters(), runs[1].params.parameters()):
        assert torch.equal(a, b)
    assert runs[0].test_f1 == runs[1].test_f1


def test_fused_csr_visit_k1_matches_plain(dev):
    """A fused visit's blockings: a group's relation at the common row
    count n_max (rows past the group's own stay empty), dedup off, both
    directions through K1 against its plain version."""
    from mpgnn_tpu_torch.train.stream import host_hop_ops

    pg, mp, _ = _planted_partition(5)
    subs = [pg.subgraph(b, halo_hops=2, halo_relations=mp[0])
            for b in ([0, 1], [2, 3], [4])]
    n_max = max(s.num_real_nodes for s in subs)
    sub = min(subs, key=lambda s: s.num_real_nodes)
    assert sub.num_real_nodes < n_max
    x = torch.randn(n_max, 16, generator=torch.Generator().manual_seed(0))
    for op in host_hop_ops(sub, mp, "csr", fused_rows=n_max)[0]:
        for blk in op[1:]:
            assert isinstance(blk, csr.CsrBlocking)
            before = csr.SCATTER_LAUNCHES
            got = csr.csr_scatter(blk.to(dev), x.to(dev))
            assert csr.SCATTER_LAUNCHES == before + 1
            want = csr.csr_scatter_plain(blk, x)
            torch.testing.assert_close(got.cpu(), want, **TOL)
            assert not got[sub.num_real_nodes:].any()


def test_hold_group_kernels_on_both_layouts(dev):
    """bench_ooc's check of a clustered run's kernels: K1 (and K2 where a
    direction routes to it) on every group's blockings as a streaming and
    a fused run built them, against the plain versions."""
    from mpgnn_tpu_torch.benchmarks.bench_ooc import hold_group_kernels
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train.stream import train_mpgnn_clustered

    pg, mp, split = _planted_partition(5)
    for fused in (False, True):
        rep = {}
        train_mpgnn_clustered(pg, mp, split, 2,
                              MPGNNConfig(epochs=2, hidden_dim=16),
                              backend="csr", resident=False, fused=fused,
                              report=rep)
        held = hold_group_kernels(pg, mp, rep, range(len(rep["groups"])),
                                  (16, pg.feat_dim))
        assert held["csr_scatter"]["blockings"] > 0
        assert all(k["close"] for k in held.values())
        if fused:
            assert held["csr_dedup"]["blockings"] == 0


# ----------------------------------------------- K1 on a shard's blockings
def _rect_case(case):
    """(rows, cols, num_rows, num_cols) of the rectangular blockings a
    node-sharded rank gives K1 (``parallel/halo.py``)."""
    rng = np.random.default_rng(7)
    if case == "empty_local":           # a shard whose edges all read others
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 50, 50
    if case == "halo_of_0_rows":        # a rank that receives nothing
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 50, 0
    if case == "halo_of_1_row":
        return rng.integers(0, 50, 30), np.zeros(30, np.int64), 50, 1
    if case == "cols_below_rows":
        return rng.integers(0, 300, 2000), rng.integers(0, 40, 2000), 300, 40
    if case == "cols_above_rows":
        return rng.integers(0, 40, 2000), rng.integers(0, 300, 2000), 40, 300
    # rows_without_edges: only the even rows have edges
    return 2 * rng.integers(0, 100, 900), rng.integers(0, 200, 900), 200, 200


@pytest.mark.parametrize("f", [1, 4, 64])
@pytest.mark.parametrize("case", ["empty_local", "halo_of_0_rows",
                                  "halo_of_1_row", "cols_below_rows",
                                  "cols_above_rows", "rows_without_edges"])
def test_k1_on_rectangular_blockings_matches_plain(dev, case, f):
    """K1 forward and backward on a shard's local or halo blocking against
    its plain version; rows without edges give 0, and a blocking of no
    rows launches nothing."""
    rows, cols, nr, nc = _rect_case(case)
    w = np.random.default_rng(1).random(len(rows)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    for blk, width in zip(csr.build_rect_csr_blocking(rows, cols, w, nr, nc),
                          (nc, nr)):
        blk = blk.to(dev)
        x = torch.randn(width, f, device=dev, generator=gen)
        before = csr.SCATTER_LAUNCHES
        got = csr.csr_scatter(blk, x)
        torch.cuda.synchronize()
        assert csr.SCATTER_LAUNCHES == before + (blk.num_rows > 0)
        assert got.shape == (blk.num_rows, f)
        torch.testing.assert_close(got, csr.csr_scatter_plain(blk, x), **TOL)
        empty = blk.row_ptr.diff() == 0
        assert bool((got[empty] == 0).all())


def _silent_rank_body(device):
    """Both exchanges and locals on 2 gloo ranks of the card where rank 1
    sends nothing: every edge reads a row of block 0."""
    from mpgnn_tpu_torch.parallel import halo
    from mpgnn_tpu_torch.parallel.mesh import all_gather_rows, make_mesh

    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 100, 600), rng.integers(0, 50, 600)
    x = rng.normal(size=(100, 8)).astype(np.float32)
    mesh = make_mesh((2,), ("nodes",), device=device)
    group = mesh.axis_group("nodes")
    out = {}
    for exchange in halo.EXCHANGES:
        plan = halo.build_halo_plan(src, dst, 100, 2, exchange)
        for local in halo.LOCALS:
            sh = plan.shard(mesh.axis_rank("nodes"), device, local)
            xl = halo.shard_graph_features(x, mesh, "nodes", device)
            xl.requires_grad_(True)
            y = halo.halo_sharded_mean_aggregate(mesh, xl, sh)
            (y ** 2).sum().backward()
            out[(exchange, local)] = (
                all_gather_rows(y.detach(), group).cpu().numpy(),
                all_gather_rows(xl.grad, group).cpu().numpy(),
                int(sh.send_idx.numel()))
    return out


def test_halo_aggregate_with_a_silent_rank_on_the_card(dev):
    """The exchange and its backward when a rank sends nothing, K1 on both
    ranks' blockings (csr) and index_add_ (segment), against the
    single-process mean and its gradient."""
    from mpgnn_tpu_torch.parallel.mesh import spawn_ranks

    res = spawn_ranks(_silent_rank_body, 2, device="cuda", timeout_s=300)
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 100, 600), rng.integers(0, 50, 600)
    x = torch.tensor(rng.normal(size=(100, 8)).astype(np.float32),
                     requires_grad=True)
    want = csr.ref_mean(x, src, dst, 100)
    (want ** 2).sum().backward()
    for key, (out, grad, _) in res[0].items():
        assert res[1][key][2] == 0, key          # rank 1 sends no row
        np.testing.assert_allclose(out, want.detach().numpy(), **TOL)
        np.testing.assert_allclose(grad, x.grad.numpy(), **TOL)


def _mag_slice(seed=0):
    """A HeteroGraph shaped as ogbn-mag at 1/32 of its nodes: papers,
    authors, institutions and fields in its proportions, its 4 relations
    and their reverses (each relation's sources a type, each of its
    destinations another), sources drawn from 90% of their type's rows."""
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph

    rng = np.random.default_rng(seed)
    sizes = {"paper": 23_012, "author": 35_458, "inst": 273, "field": 1_874}
    start = dict(zip(sizes, np.cumsum([0] + list(sizes.values()))[:-1]))

    def pick(t, e, share=1.0):
        m = int(share * sizes[t])
        return start[t] + rng.permutation(sizes[t])[:m][rng.integers(0, m, e)]

    rels = [("author", "paper", 223_302), ("paper", "paper", 169_258),
            ("paper", "field", 234_534), ("author", "inst", 32_625)]
    src, dst, typ = [], [], []
    for r, (a, b, e) in enumerate(rels):
        s, d = pick(a, e, 0.9), pick(b, e, 0.9)
        src += [s, d]
        dst += [d, s]
        typ += [np.full(e, r), np.full(e, r + 4)]
    n = sum(sizes.values())
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return HeteroGraph(x, np.concatenate(src), np.concatenate(dst),
                       np.concatenate(typ), num_relations=8)


def _rgcn_run(graph, blk, dev, tail=None):
    """logp and every gradient of one R-GCN step's loss on ``dev``, at
    every third node, the last layer on those rows alone where their
    ``tail`` blockings are given."""
    from mpgnn_tpu_torch.models.mpgnn import (
        init_rgcn_net,
        precompute_rgcn_rows,
    )

    x = torch.from_numpy(graph.x).to(dev)
    model = init_rgcn_net(16, 64, 8, 64, 5, generator=torch.Generator()
                          .manual_seed(1), device=dev)
    idx = torch.arange(0, graph.num_nodes, 3, device=dev)
    logp = model(x, blk, 3, first=precompute_rgcn_rows(x, blk), rows=idx,
                 tail=tail)
    (-logp[:, 0]).mean().backward()
    return [logp.detach()] + [p.grad for p in model.parameters()]


def test_rgcn_step_on_the_card_matches_the_plain_versions(dev, monkeypatch):
    """The R-GCN step on a mag-shaped graph, every relation's term on its
    rows: K1 on the card against the plain versions on the CPU, each on
    ``rgcn_operands``' blockings of its device: log-probabilities and
    gradients within float32 rounding (the products and the sums of each
    node's terms run in other orders on the two: rtol 1e-4, atol 1e-5).
    Two runs on the card, and each relation's term alone, repeat bitwise.
    K1 runs both ways on every relation, as on ogbn-mag: at 1/32 of its
    nodes the few institutions and fields would route some directions to
    K2."""
    from mpgnn_tpu_torch import rgcn_baseline
    from mpgnn_tpu_torch.models.mpgnn import _RowTerms
    from mpgnn_tpu_torch.models.relconv import RgcnConv
    from mpgnn_tpu_torch.train import loops

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(csr, "DEDUP_MIN_RATIO", float("inf"))
    graph = _mag_slice()
    blk = rgcn_baseline.rgcn_operands(graph, dev)
    assert blk.rels == tuple(range(8))
    got, again = _rgcn_run(graph, blk, dev), _rgcn_run(graph, blk, dev)
    want = _rgcn_run(graph, rgcn_baseline.rgcn_operands(graph, "cpu"), "cpu")
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-5)
    conv = RgcnConv(64, 64, 8, device=dev).requires_grad_(False)
    conv.init_(torch.Generator().manual_seed(2))
    args = (conv.effective_weights(), conv.bias, conv.root)
    h = torch.randn(graph.num_nodes, 64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    fwds = [hop[0][1] for hop in loops.build_hop_arrays(
        graph, [[r] for r in range(8)], "csr", dev)]
    for r in range(8):
        alone = csr.row_term_blockings([r], [fwds[r]])
        one = _RowTerms.apply(h, *args, alone, None)
        assert torch.equal(one, _RowTerms.apply(h, *args, alone, None))
        plain = _RowTerms.apply(
            h.cpu(), *(a.cpu() for a in args),
            csr.row_term_blockings([r], [fwds[r].to("cpu")]), None)
        torch.testing.assert_close(one.cpu(), plain, rtol=1e-4, atol=1e-5)


def test_rgcn_cut_step_on_the_card_matches_the_all_row_step(dev,
                                                           monkeypatch):
    """The R-GCN step with its last layer on the loss's rows alone
    (``row_term_tail`` of ``rgcn_operands``' blockings) on the mag-shaped
    graph: on the card against the all-row step on the card and against
    the cut step's plain versions on the CPU, within float32 rounding as
    above (rtol 1e-4, atol 1e-5); two cut runs on the card repeat
    bitwise."""
    from mpgnn_tpu_torch import rgcn_baseline

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(csr, "DEDUP_MIN_RATIO", float("inf"))
    graph = _mag_slice()
    idx = torch.arange(0, graph.num_nodes, 3)
    blk, cblk = (rgcn_baseline.rgcn_operands(graph, d) for d in (dev, "cpu"))
    tail = csr.row_term_tail(blk, idx.to(dev))
    assert tail.root and tail.rels == tuple(range(8))
    got, again = (_rgcn_run(graph, blk, dev, tail) for _ in range(2))
    full = _rgcn_run(graph, blk, dev)
    plain = _rgcn_run(graph, cblk, "cpu", csr.row_term_tail(cblk, idx))
    for a, b, c, d in zip(got, again, full, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a.cpu(), d, rtol=1e-4, atol=1e-5)
