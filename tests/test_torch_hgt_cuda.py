"""K6 (``csrc/csr_attention.cu``), HGT's attention, against its plain
PyTorch versions on the GPU, at the kernel's width (256 in 8 heads), on
graphs whose rows are cut into chunks (a hub row of thousands of edges, a
stacked source row that many targets read), with rows of no edge; its
repeats bitwise; and HGT's training step on the card against the same
step on the CPU (the plain versions). Marked ``cuda``: they skip where no
GPU is found. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_hgt_cuda.py -q

Tolerances, with their reasons: the kernel sums in float32 (the online
softmax's rescaled sums over chunks of at most 256 edges, its partials
folded in order), the plain versions in float64 rounded once, so values
of order 1 over rows of up to 4,000 edges are held at rtol = atol = 1e-5;
p and ds per edge at atol 1e-6 (probabilities under 1). The training step
compares float32 on the card and on the CPU, the same equations with
cuBLAS's and the CPU's float32 products in other orders: 1e-4 on the loss
and log-probabilities, and on the gradients relative to each leaf's
largest entry."""

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch.ops import attention as A
from mpgnn_tpu_torch.ops.csr import build_csr_blocking

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)
D, HEADS = A.KERNEL_WIDTH, A.KERNEL_HEADS


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _blockings(n, rels, device, rows=None, seed=0):
    """AttentionBlockings of ``rels`` random relations of n nodes: the
    first with a hub row of ~n edges (cut into chunks) and a hub source,
    nodes n - 5 .. n - 1 with no edge."""
    rng = np.random.default_rng(seed)
    fwds = []
    for r in range(rels):
        e = 6 * n
        src = rng.integers(0, n - 5, e)
        dst = rng.integers(0, n - 5, e)
        if r == 0:
            src[: n] = 3                 # one target of n edges
            dst[n: 3 * n] = 7            # one source of 2n edges
        fwds.append(build_csr_blocking(src, dst, n, dedup="never")[0]
                    .to(device))
    relabel = torch.from_numpy(rng.permutation(n)).to(device)
    if rows is not None:
        rows = torch.sort(relabel[torch.from_numpy(rows).to(device)]).values
    return A.attention_blockings(list(range(rels)), fwds, relabel, rows)


def _rows(blk, gen, device, scale=1.0):
    def r(m):
        return (torch.randn(m, D, generator=gen) * scale).to(device)
    return r(blk.num_rows), r(blk.num_sources), r(blk.num_sources)


def test_chunks_cover_every_edge_once(dev):
    blk = _blockings(700, 3, dev)
    for ptr, ch in ((blk.row_ptr, blk.chunks), (blk.t_row_ptr,
                                                blk.t_chunks)):
        p, cp = ptr.long().cpu(), ch.ptr.long().cpu()
        assert int(cp[-1]) == int(p[-1]) and bool((cp.diff() >= 0).all())
        assert int(cp.diff().max()) <= A.CHUNK
        assert ch.num_slots > 0            # some rows are cut
        row = ch.row.long().cpu()
        assert bool((cp[:-1] >= p[row]).all())
        assert bool((cp[1:] <= p[row + 1]).all())


@pytest.mark.parametrize("tail", [False, True])
def test_forward_and_backward_passes_against_plain(dev, tail):
    n = 3000
    rows = (np.random.default_rng(1).permutation(n)[:900] if tail
            else None)
    blk = _blockings(n, 3, dev, rows)
    gen = torch.Generator().manual_seed(2)
    q, kt, vt = _rows(blk, gen, dev, 0.3)
    out, lse = A.csr_attention(blk, q, kt, vt, HEADS)
    cpu = _to_cpu(blk)
    want_out, want_lse = A.attention_plain(cpu, q.cpu(), kt.cpu(),
                                           vt.cpu(), HEADS)
    torch.testing.assert_close(out.cpu(), want_out, **TOL)
    torch.testing.assert_close(lse.cpu(), want_lse, **TOL)
    dout = torch.randn(out.shape, generator=gen).to(dev)
    dq, p, ds = A.csr_attention_bwd_rows(blk, q, kt, vt, out, dout, lse,
                                         HEADS)
    wdq, wp, wds = A.attention_bwd_rows_plain(
        cpu, q.cpu(), kt.cpu(), vt.cpu(), out.cpu(), dout.cpu(), lse.cpu(),
        HEADS)
    torch.testing.assert_close(dq.cpu(), wdq, **TOL)
    torch.testing.assert_close(p.cpu(), wp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ds.cpu(), wds, rtol=1e-5, atol=1e-6)
    dkt, dvt = A.csr_attention_bwd_cols(blk, q, dout, p, ds, HEADS)
    wdk, wdv = A.attention_bwd_cols_plain(cpu, q.cpu(), dout.cpu(), p.cpu(),
                                          ds.cpu(), HEADS)
    torch.testing.assert_close(dkt.cpu(), wdk, **TOL)
    torch.testing.assert_close(dvt.cpu(), wdv, **TOL)
    # a second launch on the same input gives the same bits
    again, lse2 = A.csr_attention(blk, q, kt, vt, HEADS)
    assert torch.equal(again, out) and torch.equal(lse2, lse)
    assert torch.equal(A.csr_attention_bwd_cols(blk, q, dout, p, ds,
                                                HEADS)[0], dkt)


def test_each_pass_counts_its_launches(dev, monkeypatch):
    """The forward counts one launch in ``ATTENTION_LAUNCHES``; the row
    and the column pass of the backward one each in
    ``ATTENTION_BACKWARD_LAUNCHES``; a differentiated call counts both."""
    monkeypatch.setattr(A, "ATTENTION_LAUNCHES", 0)
    monkeypatch.setattr(A, "ATTENTION_BACKWARD_LAUNCHES", 0)
    blk = _blockings(400, 2, dev)
    gen = torch.Generator().manual_seed(4)
    q, kt, vt = _rows(blk, gen, dev, 0.3)
    out, lse = A.csr_attention(blk, q, kt, vt, HEADS)
    assert (A.ATTENTION_LAUNCHES, A.ATTENTION_BACKWARD_LAUNCHES) == (1, 0)
    dq, p, ds = A.csr_attention_bwd_rows(blk, q, kt, vt, out, out, lse,
                                         HEADS)
    assert (A.ATTENTION_LAUNCHES, A.ATTENTION_BACKWARD_LAUNCHES) == (1, 1)
    A.csr_attention_bwd_cols(blk, q, out, p, ds, HEADS)
    assert (A.ATTENTION_LAUNCHES, A.ATTENTION_BACKWARD_LAUNCHES) == (1, 2)
    w = torch.randn(2, HEADS, D // HEADS, D // HEADS, generator=gen)
    k = torch.randn(400, D, generator=gen).to(dev).requires_grad_()
    A.hgt_attention(q, k, k, w.to(dev), w.to(dev), blk).sum().backward()
    assert (A.ATTENTION_LAUNCHES, A.ATTENTION_BACKWARD_LAUNCHES) == (2, 4)


def test_rows_without_edges_give_zero(dev):
    blk = _blockings(500, 2, dev)
    gen = torch.Generator().manual_seed(3)
    q, kt, vt = _rows(blk, gen, dev)
    out, lse = A.csr_attention(blk, q, kt, vt, HEADS)
    empty = (blk.row_ptr.diff() == 0).nonzero().flatten()
    assert empty.numel() >= 5
    assert bool((out[empty] == 0).all())
    assert bool(torch.isinf(lse[empty]).all())


def test_the_kernel_refuses_other_widths(dev):
    blk = _blockings(200, 1, dev)
    q = torch.zeros(blk.num_rows, 64, device=dev)
    kv = torch.zeros(blk.num_sources, 64, device=dev)
    with pytest.raises(TypeError, match="256"):
        A.csr_attention(blk, q, kv, kv, HEADS)
    with pytest.raises(ValueError, match="heads"):
        A.csr_attention(blk, q, kv, kv, 4)


def _to_cpu(blk):
    import dataclasses

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        return x
    return move(blk)


def test_the_training_step_on_the_card_matches_the_cpu(dev):
    """Three HGT steps at width 256 in 8 heads, the card against the CPU,
    from the same parameters (the losses, and the first step's gradients);
    and the card's steps repeat bitwise."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.hgt_baseline import setup_hgt
    from mpgnn_tpu_torch.models.hgt import init_hgt_net

    rng = np.random.default_rng(4)
    n, f, c, types, rels = 600, 16, 5, 4, 4
    node_type = rng.integers(0, types, n)
    src = rng.integers(0, n - 20, 6000)
    dst = rng.integers(0, n, 6000)
    src[:800] = 11                               # a hub row
    et = rng.integers(0, rels, 6000)
    g = HeteroGraph(rng.normal(size=(n, f)).astype(np.float32), src, dst,
                    et, num_relations=rels)
    train = rng.permutation(n)[:200]
    y = rng.integers(0, c, 200)
    cfg = MPGNNConfig(hidden_dim=D, lr=1e-3, weight_decay=0.0)

    def run(device):
        model = init_hgt_net(f, D, types, rels, c, 3, HEADS,
                             generator=torch.Generator().manual_seed(5),
                             device="cpu")
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("mu", "skip")):
                    p.uniform_(-1.0, 1.0, generator=torch.Generator()
                               .manual_seed(6))
        t = setup_hgt(g, torch.from_numpy(g.x), node_type, train, y, c, 3,
                      cfg, heads=HEADS, model=model, device=device)
        losses = [float(t.step().detach())]
        grads = {k: p.grad.detach().cpu().clone()
                 for k, p in t.model.named_parameters()}
        losses += [float(t.step().detach()) for _ in range(2)]
        params = {k: p.detach().cpu().clone()
                  for k, p in t.model.named_parameters()}
        return losses, grads, params

    want = run("cpu")
    got = run(dev)
    again = run(dev)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for k, g_want in want[1].items():
        scale = float(g_want.abs().max()) or 1.0
        torch.testing.assert_close(got[1][k] / scale, g_want / scale,
                                   rtol=1e-4, atol=1e-4, msg=k)
    for k in got[2]:
        assert torch.equal(got[2][k], again[2][k]), k
    assert got[0] == again[0]
