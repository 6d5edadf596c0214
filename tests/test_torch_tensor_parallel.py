"""Tensor parallelism in one process (``parallel/mesh.py``, ``parallel/tensor.py``):

* ``make_mesh``'s factorization against JAX ``make_mesh`` over the 8
  virtual CPU devices, every device count and pinned data axis
  (tests/test_parallel.py:21-25);
* every ``Split`` of the name table: a rank's pieces join back to the
  whole tensor;
* ``shard_net`` on the DA-V2, ViT-Giant, BEiT and SwinV2 toys, for each
  model index: which pairs split (heads or hidden width dividing, no int8
  linear), the slices against the layouts they cut (DINOv2's head-major
  qkv rows, SwinV2's [q|k|v] thirds, SwiGLU's [a|b] halves, BEiT's LUT
  heads), replicated tensors shared with the source net (copied with
  ``share=False``), the source net left whole;
* a model axis of 1 runs no collective and no split."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from muggled_dpt_tpu.parallel import mesh as jax_mesh
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.ops.quant import QuantLinear
from muggled_dpt_tpu_torch.parallel.inference import BatchParallelRunner
from muggled_dpt_tpu_torch.parallel.mesh import check_world, make_mesh, mesh_coords
from muggled_dpt_tpu_torch.parallel.tensor import SPECS, Split, shard_net, spec_for_param

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
TP2 = {"data": 1, "model": 2}
SWIN = ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16)
NETS = {
    "da": lambda: make_depthanythingv2_dpt(64, 2, 4, (8, 16, 32, 64), (8, 8), 16, device=DEVICE, seed=1),
    "giant": lambda: make_depthanythingv2_dpt(64, 2, 4, (8, 16, 32, 64), (8, 8), 16, is_giant=True, device=DEVICE, seed=1),
    "beit": lambda: make_beit_dpt(64, 4, 4, (8, 16, 32, 64), (6, 6), 16, device=DEVICE, seed=1),
    "swinv2": lambda: make_swinv2_dpt(*SWIN, device=DEVICE, seed=1),
    # the first stage's 3 heads do not divide by 2: its attention runs whole
    "swinv2_undivided": lambda: make_swinv2_dpt((24, 32, 64, 128), (3, 4, 4, 8), *SWIN[2:], device=DEVICE, seed=1),
}


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("pinned", [False, True])
def test_mesh_factorization_matches_jax(n, pinned):
    """make_mesh(n) and make_mesh(n, data_parallel=d) for every d dividing n
    give JAX's mesh shape; make_mesh(8) is 2 x 4."""
    assert jax.device_count() == 8
    for dp in ([d for d in range(1, n + 1) if n % d == 0] if pinned else [None]):
        assert make_mesh(n, data_parallel=dp) == dict(jax_mesh.make_mesh(n, data_parallel=dp).shape), (n, dp)
    assert make_mesh(8) == {"data": 2, "model": 4} and make_mesh(8, data_parallel=8) == {"data": 8, "model": 1}


def test_mesh_coords_and_world_checks():
    """Rank r sits at (r // model, r % model), JAX's devices.reshape(data,
    model); a mesh that does not cover the world, or a data axis that does
    not divide, is refused."""
    mesh = make_mesh(8)
    assert [mesh_coords(r, mesh) for r in range(8)] == [(r // 4, r % 4) for r in range(8)]
    check_world(mesh, 8)
    with pytest.raises(ValueError, match="mesh data axis 2 != world size 4 over model axis 4"):
        check_world(mesh, 4)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(6, data_parallel=4)


@pytest.mark.parametrize("pattern,split", SPECS)
def test_split_pieces_join_to_the_whole(pattern, split):
    """Each table entry's pieces at a model axis of 2 and 4 join back to the
    whole tensor; piece m of a part-cut dim holds the m-th chunk of every part."""
    shape = [4, 24, 8]
    shape[split.dim] = 24 * split.parts
    whole = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    for tp in (2, 4):
        pieces = [split.take(whole, m, tp) for m in range(tp)]
        assert all(p.is_contiguous() and p.shape[split.dim] == shape[split.dim] // tp for p in pieces)
        assert torch.equal(split.join(pieces), whole)
        part = whole.unflatten(split.dim, (split.parts, -1)).select(split.dim, split.parts - 1)
        last = pieces[1].unflatten(split.dim, (split.parts, -1)).select(split.dim, split.parts - 1)
        assert torch.equal(last, part.narrow(split.dim, part.shape[split.dim] // tp, part.shape[split.dim] // tp))


def _expected_splits(name, net) -> set:
    """The parameter names that must split at a model axis of 2."""
    names = {n for n, _ in net.named_parameters()}
    if name.startswith("swinv2"):
        heads = [s[0].num_heads for s in net.encoder.stages]
        keep = {f"encoder.stages.{s}." for s, h in enumerate(heads) if h % 2}
        attention = (".qkv.", ".proj.weight", ".logit_scale", ".cpb1.")
        return {n for n in names if spec_for_param(n) and not (any(n.startswith(k) for k in keep)
                                                               and any(a in n for a in attention))}
    return {n for n in names if spec_for_param(n)}


@pytest.mark.parametrize("name", list(NETS))
def test_shard_net_slices_and_shares(name):
    """For both model indices: the split parameters are the pairs'
    (and the per-head tables'), each the rank's piece of the source's, and
    every other parameter the very tensor of the source net (with
    ``share=False`` an equal copy in storage of its own), which keeps its
    whole weights and head counts."""
    model = NETS[name]()
    net = model.net
    before = {k: v.clone() for k, v in net.state_dict().items()}
    heads = [b.num_heads for b in net.modules() if hasattr(b, "num_heads")]
    source = dict(net.named_parameters())
    for index in range(2):
        local = shard_net(net, TP2, index, model_group=object())
        tp = local.tensor_parallel
        assert tp.model_index == index and tp.mesh == TP2
        assert set(tp.splits) == _expected_splits(name, net)
        for k, p in local.named_parameters():
            if k in tp.splits:
                assert torch.equal(p, tp.splits[k].take(source[k].detach(), index, 2)), k
                assert p is not source[k] and p.requires_grad == source[k].requires_grad
            else:
                assert p is source[k], k
        for n, m in local.named_modules():
            if hasattr(m, "num_heads"):
                whole = net.get_submodule(n).num_heads
                qkv = f"{n}.attn.qkv.weight" if hasattr(m, "attn") else f"{n}.qkv.weight"
                assert m.num_heads == (whole // 2 if qkv in tp.splits else whole), n
        for k in tp.splits:
            if k.endswith("qkv.weight"):
                layer = local.get_submodule(k.rsplit(".", 1)[0])
                assert layer.out_features == layer.weight.shape[0] == source[k].shape[0] // 2
    copied = shard_net(net, TP2, 0, model_group=object(), share=False)
    for k, p in copied.named_parameters():
        assert p.data_ptr() != source[k].data_ptr(), k
        assert k in copied.tensor_parallel.splits or torch.equal(p, source[k]), k
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert [b.num_heads for b in net.modules() if hasattr(b, "num_heads")] == heads


def test_head_major_and_thirds_layouts():
    """The slices are the rank's heads in each family's qkv layout: DINOv2's
    rows [head][q|k|v][dim] give rank 1 heads 1 (of 2) whole; SwinV2's
    [q|k|v][head][dim] give it heads 1 of each third; SwiGLU's w12 gives
    it the second half of a and of b; BEiT's LUT its heads' columns."""
    da = NETS["da"]().net
    q = da.encoder.blocks[0].attn.qkv.weight.detach()  # (3 * 64, 64): 2 heads of 32
    local = shard_net(da, TP2, 1, model_group=object())
    assert torch.equal(local.encoder.blocks[0].attn.qkv.weight, q[96:])
    swin = NETS["swinv2"]().net
    block = swin.encoder.stages[1][0]  # 4 heads of 8, rows [q|k|v][head][dim]
    w = block.qkv.weight.detach().reshape(3, 4, 8, -1)
    mine = shard_net(swin, TP2, 1, model_group=object()).encoder.stages[1][0]
    assert torch.equal(mine.qkv.weight, w[:, 2:].reshape(3 * 16, -1)) and mine.num_heads == 2
    assert torch.equal(mine.logit_scale, block.logit_scale[2:]) and torch.equal(mine.cpb1.weight, block.cpb1.weight[2:])
    giant = NETS["giant"]().net
    w12 = giant.encoder.blocks[0].mlp.w12.weight.detach()
    a, b = w12.chunk(2)
    half = a.shape[0] // 2
    got = shard_net(giant, TP2, 1, model_group=object()).encoder.blocks[0].mlp.w12.weight
    assert torch.equal(got, torch.cat([a[half:], b[half:]]))
    beit = NETS["beit"]().net
    lut = beit.encoder.relpos_lut.detach()
    assert torch.equal(shard_net(beit, TP2, 0, model_group=object()).encoder.relpos_lut, lut[..., :2])


@pytest.mark.parametrize("include_qkv", [False, True])
def test_int8_pairs_stay_whole(include_qkv):
    """A pair with an int8 linear runs whole (the default tier's int8 proj
    keeps its dense qkv whole too); SwinV2's int8 MLP stays whole while its
    dense attention splits."""
    q = NETS["da"]().quantize_encoder_int8(include_qkv=include_qkv)
    local = shard_net(q.net, TP2, 0, model_group=object())
    assert local.tensor_parallel.splits == {}
    assert all(b.num_heads == 2 for b in local.encoder.blocks)
    s = NETS["swinv2"]().quantize_encoder_int8()
    assert isinstance(s.net.encoder.stages[0][0].fc1, QuantLinear)
    splits = shard_net(s.net, TP2, 0, model_group=object()).tensor_parallel.splits
    assert splits and not any(".fc1." in k or ".fc2." in k for k in splits)


@pytest.mark.parametrize("name", ["da", "beit", "swinv2"])
def test_model_axis_one_runs_no_collective(name, monkeypatch):
    """At a model axis of 1 the runner's model is the caller's, no block
    holds a group, and the forward calls no collective."""
    def refuse(*a, **k):
        raise AssertionError("a collective ran at a model axis of 1")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    model = NETS[name]()
    runner = BatchParallelRunner(model, mesh=make_mesh(1))
    assert runner.local is model and not hasattr(model.net, "tensor_parallel")
    groups = [getattr(m, a) for m in model.net.modules() for a in ("model_group", "attn_group", "mlp_group")
              if hasattr(m, a)]
    assert groups and all(g is None for g in groups)
    side = {"da": 56, "beit": 96, "swinv2": 64}[name]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, side, side, 3)).astype(np.float32))
    assert torch.equal(runner(x), model.forward(x.permute(0, 3, 1, 2)))


def test_spec_table_names():
    """The table reads the port's parameter names: the same leaf splits by
    its family's layout, and norms, embeddings and the neck replicate."""
    assert spec_for_param("encoder.blocks.3.attn.qkv.weight") == Split(0)
    assert spec_for_param("encoder.stages.2.5.qkv.bias") == Split(0, 3)
    assert spec_for_param("encoder.blocks.0.mlp.w12.weight") == Split(0, 2)
    assert spec_for_param("encoder.blocks.0.attn.proj.weight") == Split(1)
    assert spec_for_param("encoder.blocks.0.attn.proj.bias") is None  # added once, after the sum
    for name in ("encoder.blocks.0.norm1.weight", "encoder.pos_embed", "encoder.stages.0.0.cpb0.weight",
                 "reassemble.0.proj.weight", "fusion.0.out.weight", "head.conv_in.weight", "encoder.merges.0.reduction.weight"):
        assert spec_for_param(name) is None, name
