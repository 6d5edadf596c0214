"""Tensor parallelism on two gloo CPU ranks (mesh data 1 x model 2), held
against the JAX package on the same weights (the port's factories make the
JAX factories' weights for a seed) and inputs (numpy, from a seed). One world
does every rank-side check, since each spawn costs seconds:

* ``BatchParallelRunner(shard_model=True)`` on DA-V2 (4 heads and a 2-head
  toy), ViT-Giant's SwiGLU, BEiT (cached bias stack and inline) and SwinV2
  (also one whose first stage's 3 heads do not divide by 2, and run whole)
  against JAX's single-device forward and JAX's ``BatchParallelRunner(model,
  mesh=make_mesh(2, data_parallel=1))`` (2e-4, the JAX tests' tolerance);
* each rank's BEiT stack: half the heads, equal to its heads of the full
  stack; SwinV2's CPB stacks likewise;
* the int8 tiers: every quantized pair whole, the +qkv model's tp=2 forward
  equal to its own single-process forward;
* one dp1 x tp2 train step per family: the loss and the gradients, the
  split ones reassembled, against ``jax.value_and_grad`` (1e-5 loss, 1e-4
  per gradient), so the Megatron pair neither drops nor scales a gradient;
* ``sharded_train_demo`` at tp=2 leaves the caller's model as it was;
* checkpoints across mesh shapes: written at tp=2 and resumed in one
  process, written in one process and resumed at tp=2, the losses those of
  an uninterrupted run;
* ``tools/finetune_demo.py -tp 2`` (data 1 x model 2) CONVERGED, resumed
  in one process."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_beit
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_da
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_swin
from muggled_dpt_tpu.parallel import inference as jax_inference
from muggled_dpt_tpu.parallel import mesh as jax_mesh
from muggled_dpt_tpu.parallel import train as jax_train
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.checkpoints.from_jax import beit_params_from_jax, params_from_jax, swinv2_params_from_jax
from muggled_dpt_tpu_torch.parallel import checkpoint as ck
from muggled_dpt_tpu_torch.parallel.inference import BatchParallelRunner
from muggled_dpt_tpu_torch.parallel.mesh import spawn
from muggled_dpt_tpu_torch.parallel.tensor import shard_model
from muggled_dpt_tpu_torch.parallel.train import adamw, make_train_step, sharded_train_demo
from muggled_dpt_tpu_torch.tools import finetune_demo

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
MESH = {"data": 1, "model": 2}
SEED = 3
TOL = 2e-4  # tests/test_parallel.py's tensor-parallel tolerance
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_FLOOR = 1e-4
GRAD_SEED = 0  # tests/test_torch_parallel.py:GRAD_SEED, a well-conditioned input
LR = 3e-4
RESUME_STEPS = 3
SWIN = ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16)
CASES = {  # name: (port factory, JAX factory, positional config, keywords, image side)
    "da": (make_depthanythingv2_dpt, jax_make_da, (128, 4, 4, (8, 16, 32, 64), (8, 8), 16), {}, 56),
    "da_two_heads": (make_depthanythingv2_dpt, jax_make_da, (64, 2, 4, (8, 16, 32, 64), (8, 8), 16), {}, 56),
    "giant": (make_depthanythingv2_dpt, jax_make_da, (64, 2, 4, (8, 16, 32, 64), (8, 8), 16), {"is_giant": True}, 56),
    "beit": (make_beit_dpt, jax_make_beit, (64, 4, 4, (8, 16, 32, 64), (6, 6), 16), {}, 96),
    "beit_inline": (make_beit_dpt, jax_make_beit, (64, 4, 4, (8, 16, 32, 64), (6, 6), 16), {"enable_cache": False}, 96),
    "swinv2": (make_swinv2_dpt, jax_make_swin, SWIN, {}, 64),
    # the first stage: 24 features in 3 heads of 8, which do not divide by the model axis
    "swinv2_undivided": (make_swinv2_dpt, jax_make_swin, ((24, 32, 64, 128), (3, 4, 4, 8), *SWIN[2:]), {}, 64),
}
TRAINED = {"da_two_heads": params_from_jax, "beit": beit_params_from_jax, "swinv2": swinv2_params_from_jax}


def _ours(name, **extra):
    make, _, cfg, kw, _ = CASES[name]
    return make(*cfg, **{**kw, **extra}, device=DEVICE, seed=SEED)


def _frames(name, seed=5):
    side = CASES[name][4]
    return np.random.default_rng(seed).standard_normal((2, side, side, 3)).astype(np.float32)


def _train_batch(side, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, side, side, 3)).astype(np.float32),
            rng.uniform(0.1, 1.0, (2, side, side)).astype(np.float32))


def _grid(name):
    side, p = CASES[name][4], (16 if "beit" in name else 4 if "swin" in name else 14)
    return (side // p, side // p)


def _grads(net) -> dict:
    return {k: p.grad.detach().clone() for k, p in net.named_parameters() if p.grad is not None}


def _train(model, optimizer, images, targets, n):
    step = make_train_step(model, optimizer)
    return [float(step(images, targets)) for _ in range(n)]


def _tp_rank(rank, world_size, workdir):
    """Every rank-side check of the module; each rank writes rank<r>.pt."""
    torch.manual_seed(0)
    out = {"splits": {}, "heads": {}}
    for name in CASES:
        model = _ours(name)
        runner = BatchParallelRunner(model, mesh=MESH)
        x = torch.from_numpy(_frames(name))
        out[name] = runner(x)
        out["splits"][name] = sorted(runner.local.net.tensor_parallel.splits)
        enc = runner.local.net.encoder
        out["heads"][name] = [s[0].num_heads for s in enc.stages] if hasattr(enc, "stages") else enc.blocks[0].num_heads
        aux = runner.local._aux_cache.get(_grid(name))
        if name in ("beit", "swinv2"):
            out[f"{name}_aux"] = (aux, model._get_aux(_grid(name)))
    # the int8 tiers: the default keeps qkv dense and quantizes proj, +qkv quantizes both
    base = _ours("da_two_heads")
    for tier, include_qkv in (("int8", False), ("int8_qkv", True)):
        q = base.quantize_encoder_int8(include_qkv=include_qkv)
        runner = BatchParallelRunner(q, mesh=MESH)
        x = torch.from_numpy(_frames("da_two_heads"))
        out[tier] = (runner(x), q.forward(x.permute(0, 3, 1, 2)), sorted(runner.local.net.tensor_parallel.splits))
    # one train step per family on the split model, its aux threaded in
    for name in TRAINED:
        model = shard_model(_ours(name), MESH)
        images, targets = _train_batch(CASES[name][4], GRAD_SEED)
        loss = make_train_step(model, adamw(model.net.parameters(), LR))(images, targets, model._get_aux(_grid(name)))
        out[f"train_{name}"] = (float(loss), _grads(model.net), model.net.tensor_parallel.splits)
    # checkpoints: the step-0 state gathered whole; 3 steps written at tp=2; a single-process step 3 resumed here
    d = np.load(os.path.join(workdir, "scene.npz"))
    images, targets = torch.from_numpy(d["images"]), torch.from_numpy(d["targets"])
    model = shard_model(_ours("da_two_heads"), MESH)
    optimizer = adamw(model.net.parameters(), LR)
    ck.save_train_state(os.path.join(workdir, "ck_tp2_start"), 0, model.net, optimizer)
    out["losses_tp2"] = _train(model, optimizer, images, targets, RESUME_STEPS)
    ck.save_train_state(os.path.join(workdir, "ck_tp2"), RESUME_STEPS, model.net, optimizer)
    model = shard_model(_ours("da_two_heads"), MESH)
    optimizer = adamw(model.net.parameters(), LR)
    _, _, step = ck.restore_train_state(os.path.join(workdir, "ck_tp1"), model.net, optimizer)
    tp = model.net.tensor_parallel
    out["restored"] = (step, {k: v.clone() for k, v in model.net.state_dict().items()}, tp.splits, tp.model_index)
    out["losses_resumed_tp2"] = _train(model, optimizer, images, targets, RESUME_STEPS)
    # sharded_train_demo at tp=2 trains a split copy: the caller's model keeps every tensor
    model = _ours("da_two_heads")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    loss = sharded_train_demo(model, MESH)
    out["demo"] = (loss, [k for k, v in model.net.state_dict().items() if not torch.equal(v, before[k])])
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The uninterrupted single-process run and its step-3 checkpoint, then
    the two-rank world; returns each rank's results and the paths."""
    workdir = tmp_path_factory.mktemp("tp")
    images, targets = finetune_demo.synthetic_scene(np.random.default_rng(3), 2, (28, 28))
    np.savez(workdir / "scene.npz", images=images, targets=targets)
    model = _ours("da_two_heads")
    optimizer = adamw(model.net.parameters(), LR)
    first = _train(model, optimizer, images, targets, RESUME_STEPS)
    ck.save_train_state(str(workdir / "ck_tp1"), RESUME_STEPS, model.net, optimizer)
    rest = _train(model, optimizer, images, targets, RESUME_STEPS)
    spawn(_tp_rank, 2, str(workdir), device_type="cpu")
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "dir": workdir, "uninterrupted": first + rest, "scene": (images, targets)}


def _jax(name):
    _, jax_make, cfg, kw, _ = CASES[name]
    return jax_make(*cfg, **kw, dtype=jnp.float32, seed=SEED)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_forward_matches_jax(world, name):
    """tests/test_parallel.py:113's check on the port: the two ranks' depth,
    each the whole batch, equals JAX's single-device forward and JAX's own
    tensor-parallel runner on two virtual devices."""
    theirs = _jax(name)
    x = _frames(name)
    single = np.asarray(jax.jit(theirs.spec["forward"])(theirs.params, jnp.asarray(x), theirs._get_aux(_grid(name))))
    sharded = np.asarray(jax_inference.BatchParallelRunner(theirs, mesh=jax_mesh.make_mesh(2, data_parallel=1))(x))
    for rank, got in enumerate(r[name].numpy() for r in world["ranks"]):
        assert got.shape == single.shape
        np.testing.assert_allclose(got, single, rtol=TOL, atol=TOL, err_msg=f"{name} rank {rank} vs JAX single")
        np.testing.assert_allclose(got, sharded, rtol=TOL, atol=TOL, err_msg=f"{name} rank {rank} vs JAX tp=2")


@pytest.mark.parametrize("name", list(CASES))
def test_local_heads_and_splits(world, name):
    """The rank's head counts and split parameters: every pair split where
    its heads and hidden width divide; SwinV2's undivided first stage whole
    (its qkv, proj, logit scale and CPB rows), its MLP and the other stages
    split; BEiT's LUT follows the heads."""
    r0, r1 = world["ranks"]
    assert r0["splits"][name] == r1["splits"][name]
    splits = r0["splits"][name]
    heads = r0["heads"][name]
    if name.startswith("swinv2"):
        assert heads == ([3, 2, 2, 4] if name == "swinv2_undivided" else [1, 2, 2, 4])
        stage0 = [s for s in splits if s.startswith("encoder.stages.0.")]
        attention = [s for s in stage0 if s.split(".")[4] in ("qkv", "proj", "logit_scale", "cpb1")]
        assert bool(attention) == (name == "swinv2")
        assert "encoder.stages.0.0.fc1.weight" in splits and "encoder.stages.3.1.qkv.weight" in splits
    else:
        assert heads == CASES[name][2][1] // 2
        assert ("encoder.relpos_lut" in splits) == name.startswith("beit")
        mlp = ("w12", "w3") if name == "giant" else ("fc1", "fc2")
        assert f"encoder.blocks.0.mlp.{mlp[0]}.weight" in splits and f"encoder.blocks.0.mlp.{mlp[1]}.weight" in splits
        assert "encoder.blocks.0.attn.qkv.bias" in splits and "encoder.blocks.0.attn.proj.bias" not in splits
    assert not any(s.startswith(("reassemble", "fusion", "head")) for s in splits)


def test_beit_and_swinv2_stacks_split_by_head(world):
    """tests/test_parallel.py:54-95 on the port: each rank's cached BEiT
    stack holds its 2 of the 4 heads, half the bytes, equal to those heads of
    the single-process stack; SwinV2's CPB stacks likewise, the shift masks
    (no head axis) whole."""
    for rank, r in enumerate(world["ranks"]):
        local, full = r["beit_aux"]
        assert local.shape == (4, 2, *full.shape[2:]) and 2 * local.numel() == full.numel()
        assert torch.equal(local, full[:, 2 * rank:2 * rank + 2])
        local, full = r["swinv2_aux"]
        for mine, whole in zip(local, full):
            h = mine["cpb"].shape[1]
            assert 2 * h == whole["cpb"].shape[1]
            torch.testing.assert_close(mine["cpb"], whole["cpb"][:, h * rank:h * (rank + 1)], rtol=1e-6, atol=1e-6)
            assert (mine["mask"] is None) == (whole["mask"] is None)
            assert mine["mask"] is None or torch.equal(mine["mask"], whole["mask"])


@pytest.mark.parametrize("tier", ["int8", "int8_qkv"])
def test_int8_pairs_run_whole(world, tier):
    """A quantized pair stays whole on every rank (JAX's quantize_weight
    drops the dense kernels _spec_for_param would split): the default tier
    (proj int8) and +qkv split nothing, and the +qkv model's tp=2 forward
    equals its own single-process forward."""
    for r in world["ranks"]:
        got, single, splits = r[tier]
        assert splits == []
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-6, atol=1e-6)


def _grad_errors(ours: dict, ref: dict) -> dict:
    top = max(float(v.norm()) for v in ref.values())
    out = {}
    for k, g in ours.items():
        n = float(ref[k].norm())
        out[k] = float(g.norm()) / top if n < ZERO_FLOOR * top else float((g - ref[k]).norm()) / n
    return out


@pytest.mark.parametrize("name", list(TRAINED))
def test_train_step_matches_jax_value_and_grad(world, name):
    """The dp1 x tp2 step's loss, and every gradient with the split ones
    reassembled from the two ranks, against ``jax.value_and_grad`` of the
    loss JAX ``make_train_step`` differentiates: a replicated parameter's
    gradient is whole on each rank (the Megatron pair neither drops it nor
    multiplies it by 2), and each rank's slice is its part of the whole."""
    theirs = _jax(name)
    images, targets = _train_batch(CASES[name][4], GRAD_SEED)
    aux = theirs._get_aux(_grid(name))

    def loss_fn(params):
        return jax_train.ssi_loss(theirs.spec["forward"](params, jnp.asarray(images), aux), jnp.asarray(targets))

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(theirs.params)
    ref = TRAINED[name](jax.tree_util.tree_map(np.asarray, grads_j))
    (loss0, g0, splits), (loss1, g1, _) = (r[f"train_{name}"] for r in world["ranks"])
    assert loss0 == loss1 and abs(loss0 - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j)), (loss0, float(loss_j))
    assert set(g0) == set(g1) and set(g0) <= set(ref)
    grads = {k: splits[k].join([g0[k], g1[k]]) if k in splits else g0[k] for k in g0}
    for k in g0:
        if k not in splits:
            assert torch.equal(g0[k], g1[k]), k  # replicated: the same whole gradient on both ranks
    bad = {k: v for k, v in _grad_errors(grads, ref).items() if v > GRAD_RTOL}
    assert not bad, bad
    assert any(".qkv." in k for k in splits) and any(".proj." in k for k in splits)


def test_sharded_train_demo_leaves_the_callers_model_whole(world):
    """sharded_train_demo on a dp1 x tp2 mesh: one finite loss, the same on
    both ranks, and the model it was given unchanged (its split copy trained,
    none of its replicated tensors stepped through shared storage)."""
    (loss0, changed0), (loss1, changed1) = (r["demo"] for r in world["ranks"])
    assert np.isfinite(loss0) and loss0 == loss1
    assert changed0 == [] and changed1 == []


def test_checkpoint_written_at_tp2_restores_in_one_process(world):
    """A tp=2 checkpoint holds the whole state: at step 0 exactly the
    model's, at step 3 restored into a single-process model whose next 3
    losses are those of the uninterrupted run."""
    d = world["dir"]
    start = torch.load(d / "ck_tp2_start" / "step_0" / ck.STATE_FILE, weights_only=True)
    init = _ours("da_two_heads").net.state_dict()
    assert set(start["params"]) == set(init)
    for k, v in init.items():
        assert torch.equal(start["params"][k], v), k
    r0, r1 = world["ranks"]
    assert r0["losses_tp2"] == r1["losses_tp2"]
    model = _ours("da_two_heads")
    optimizer = adamw(model.net.parameters(), LR)
    _, _, step = ck.restore_train_state(str(d / "ck_tp2"), model.net, optimizer)
    assert step == RESUME_STEPS
    losses = r0["losses_tp2"] + _train(model, optimizer, *world["scene"], RESUME_STEPS)
    np.testing.assert_allclose(losses, world["uninterrupted"], rtol=LOSS_RTOL)


def test_checkpoint_written_in_one_process_restores_at_tp2(world):
    """A single-process step-3 checkpoint restored on two ranks: each rank
    holds exactly its slices of the saved tensors, and the next 3 losses are
    those of the uninterrupted run."""
    saved = torch.load(world["dir"] / "ck_tp1" / f"step_{RESUME_STEPS}" / ck.STATE_FILE, weights_only=True)["params"]
    for rank, r in enumerate(world["ranks"]):
        step, state, splits, index = r["restored"]
        assert step == RESUME_STEPS and index == rank
        for k, v in state.items():
            want = splits[k].take(saved[k], rank, 2) if k in splits else saved[k]
            assert torch.equal(v, want), k
        np.testing.assert_allclose(r["losses_resumed_tp2"], world["uninterrupted"][RESUME_STEPS:], rtol=LOSS_RTOL)


def test_finetune_demo_tensor_parallel_converges_and_resumes(tmp_path, capsys):
    """tools/finetune_demo.py -tp 2 on the mesh data 1 x model 2 (two gloo
    ranks, the tiny model's 2 heads split): CONVERGED
    (exit 0), its checkpoints written whole; then resumed in one process:
    RESUMED OK."""
    d = str(tmp_path / "ck")
    assert finetune_demo.main(["-d", DEVICE, "-tp", "2", "--steps", "30", "--ckpt_dir", d, "--save_every", "15"]) == 0
    assert ck.list_steps(d) == [15, 30]
    assert finetune_demo.main(["-d", DEVICE, "--steps", "36", "--ckpt_dir", d, "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {d} step 30" in out and "RESUMED OK" in out
