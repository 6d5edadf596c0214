"""The port's data-parallel and training layer (``muggled_dpt_tpu_torch.parallel``)
on the CPU, against the JAX package's ``parallel/`` on the same inputs
(made from a seed with numpy) and weights (the JAX model's parameters
through ``checkpoints/from_jax.py``):

* ``ssi_loss`` against JAX's (1e-6);
* one train step's loss (1e-5 relative) and every parameter's gradient
  (1e-4 relative per tensor) against ``jax.value_and_grad`` of the loss JAX
  ``make_train_step`` differentiates, on the tiny DA-V2, and on BEiT and
  SwinV2 with their cached aux threaded in (relative-position tables and
  CPB MLPs: zero gradient in both packages); the key bias BEiT and SwinV2
  do not have stays zero;
* one AdamW step's parameters within 2 lr of ``optax.adamw``'s (first-step
  Adam moves each weight by about lr times the sign of its gradient, so a
  gradient at float noise can flip it: tests/test_parallel.py:312);
* the differentiated forward runs the plain attention, never a kernel;
* two gloo ranks: the data-parallel step against the single-process
  full-batch step, the runner against a single one, and restores across
  world sizes 1 -> 2 and 2 -> 1;
* checkpoint resume against uninterrupted training, ``keep`` pruning;
* the mesh shape (JAX's default model axis; tests/test_torch_tensor_parallel*.py
  hold the factorization and the model axis), ``shard_batch``;
* ``tools/finetune_demo.py`` CONVERGED in 30 steps and RESUMED OK."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_beit
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_da
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_swin
from muggled_dpt_tpu.parallel import train as jax_train
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.checkpoints.from_jax import beit_params_from_jax, params_from_jax, swinv2_params_from_jax
from muggled_dpt_tpu_torch.models import beit_family
from muggled_dpt_tpu_torch.ops import nn as port_nn
from muggled_dpt_tpu_torch.parallel import checkpoint as ck
from muggled_dpt_tpu_torch.parallel.inference import BatchParallelRunner
from muggled_dpt_tpu_torch.parallel.mesh import make_mesh, shard_batch, spawn
from muggled_dpt_tpu_torch.parallel.train import (
    adamw,
    fixed_zero_grads,
    make_train_step,
    sharded_train_demo,
    ssi_loss,
)
from muggled_dpt_tpu_torch.tools import finetune_demo

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_FLOOR = 1e-4
# The images of the gradient comparison against JAX. At random init a tiny
# model's float32 gradients are ill-conditioned at some inputs: a ReLU input
# within float32 noise of 0 flips between two float32 runs, and a float32
# gradient then sits up to 2.2e-3 from the float64 one, JAX's own included
# (DA-V2, images of seeds 1, 2 and 4; BEiT at seed 7, 4.9e-2 from one flipped
# element of the reassembly map). Seed 0 is well conditioned for all three
# families: both packages' float32 gradients within 3.3e-5 of float64.
GRAD_SEED = 0
LR = 3e-4
FAMILIES = {  # family: (port factory, JAX factory, positional config, from_jax, image side)
    "da": (make_depthanythingv2_dpt, jax_make_da, (64, 1, 4, (8, 16, 32, 64), (8, 8), 16), params_from_jax, 56),
    "beit": (make_beit_dpt, jax_make_beit, (64, 4, 4, (8, 16, 32, 64), (6, 6), 16), beit_params_from_jax, 96),
    "swinv2": (make_swinv2_dpt, jax_make_swin, ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4),
                                                (None,) * 4, 16), swinv2_params_from_jax, 64),
}


def _pair(family):
    """(port model, JAX model) of a family in float32, the port's weights the JAX model's."""
    make, jax_make, cfg, from_jax, _ = FAMILIES[family]
    theirs = jax_make(*cfg, dtype=jnp.float32)
    ours = make(*cfg, device=DEVICE)
    ours.net.load_state_dict(from_jax(jax.tree_util.tree_map(np.asarray, theirs.params)), strict=True)
    return ours, theirs


def _batch(side, b=2, seed=7):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    targets = rng.uniform(0.1, 1.0, (b, side, side)).astype(np.float32)
    return images, targets


def _grads(net) -> dict:
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()) for k, p in net.named_parameters()}


def _grad_errors(ours: dict, ref: dict) -> dict:
    """Per tensor, ||ours - ref|| / ||ref||. A reference gradient below
    ZERO_FLOOR of the largest one is zero up to float noise (head.proj.bias:
    the SSI loss does not see a global shift of the depth), and ours must be
    too: its error is then its norm over the largest reference norm."""
    top = max(float(v.norm()) for v in ref.values())
    errors = {}
    for k, g in ours.items():
        ref_norm = float(ref[k].norm())
        if ref_norm < ZERO_FLOOR * top:
            errors[k] = float(g.norm()) / top
        else:
            errors[k] = float((g - ref[k]).norm()) / ref_norm
    return errors


# -- loss, mesh, shards -------------------------------------------------------


def test_ssi_loss_matches_jax_and_is_invariant():
    rng = np.random.default_rng(0)
    t = rng.uniform(0.1, 1.0, (2, 16, 16)).astype(np.float32)
    p = rng.standard_normal(t.shape).astype(np.float32)
    mask = (rng.uniform(size=t.shape) > 0.3).astype(np.float32)
    for m in (None, mask):
        ours = float(ssi_loss(torch.from_numpy(p), torch.from_numpy(t), None if m is None else torch.from_numpy(m)))
        theirs = float(jax_train.ssi_loss(jnp.asarray(p), jnp.asarray(t), None if m is None else jnp.asarray(m)))
        assert abs(ours - theirs) <= 1e-6 * max(1.0, abs(theirs)), (ours, theirs)
    assert float(ssi_loss(torch.from_numpy(3.5 * t - 0.7), torch.from_numpy(t))) < 1e-8
    assert float(ssi_loss(torch.from_numpy(p), torch.from_numpy(t))) > 1e-4
    assert ssi_loss(torch.from_numpy(p).bfloat16(), torch.from_numpy(t)).dtype == torch.float32


def test_mesh_shape_and_shards():
    assert make_mesh() == {"data": 1, "model": 1}
    assert make_mesh(4, data_parallel=4) == {"data": 4, "model": 1}
    assert make_mesh(4, data_parallel=2) == {"data": 2, "model": 2}
    assert make_mesh(4) == {"data": 1, "model": 4} and make_mesh(8) == {"data": 2, "model": 4}
    x = torch.arange(12).reshape(6, 2)
    a, b = shard_batch((x, x.numpy()), rank=2, world_size=3)
    assert torch.equal(a, x[4:6]) and np.array_equal(b, x.numpy()[4:6])
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(x, rank=0, world_size=4)


# -- one train step against JAX -----------------------------------------------


@pytest.mark.parametrize("family", ["da", "beit", "swinv2"])
def test_train_step_matches_jax_value_and_grad(family):
    ours, theirs = _pair(family)
    side = FAMILIES[family][4]
    images, targets = _batch(side, seed=GRAD_SEED)
    p = ours.patch_size_px
    grid = (side // p, side // p)
    aux_j = theirs._get_aux(grid)
    aux_t = ours._get_aux(grid)
    assert (aux_j is None) == (aux_t is None) == (family == "da")

    fwd = theirs.spec["forward"]

    def loss_fn(params):
        return jax_train.ssi_loss(fwd(params, jnp.asarray(images), aux_j), jnp.asarray(targets))

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(theirs.params)
    ref = FAMILIES[family][3](jax.tree_util.tree_map(np.asarray, grads_j))

    optimizer = adamw(ours.net.parameters(), LR)
    loss_t = float(make_train_step(ours, optimizer)(images, targets, aux_t))
    assert abs(loss_t - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j)), (loss_t, float(loss_j))
    grads = _grads(ours.net)
    assert set(grads) <= set(ref), set(grads) - set(ref)
    bad = {k: v for k, v in _grad_errors(grads, ref).items() if v > GRAD_RTOL}
    assert not bad, bad
    # the cached aux is data: no gradient reaches the tables it was built from
    frozen = {"beit": ["encoder.relpos_lut"], "swinv2": [k for k in grads if ".cpb" in k], "da": []}[family]
    for k in frozen:
        assert float(ref[k].abs().max()) == 0.0 and float(grads[k].abs().max()) == 0.0, k
    # the key bias the original does not have: zero gradient, still zero after the step
    zeros = fixed_zero_grads(ours.net)  # declared by BEiT's encoder and SwinV2's blocks; DINOv2 has a key bias
    assert bool(zeros) == (family != "da")
    for param, mask in zeros:
        assert int(mask.sum()) == param.numel() // 3 and float(param.detach()[mask].abs().max()) == 0.0


def test_adamw_step_within_two_lr_of_optax():
    ours, theirs = _pair("da")
    images, targets = _batch(56)
    optimizer = optax.adamw(LR)
    params = theirs.params
    step = jax.jit(jax_train.make_train_step(lambda p, x, aux: theirs.spec["forward"](p, x, aux), optimizer))
    with jax.default_matmul_precision("highest"):
        new_params, _, _ = step(params, optimizer.init(params), jnp.asarray(images), jnp.asarray(targets))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    before = {k: v.detach().clone() for k, v in ours.net.named_parameters()}
    make_train_step(ours, adamw(ours.net.parameters(), LR))(images, targets)
    moved = 0
    for k, v in ours.net.named_parameters():
        assert float((v.detach() - ref[k]).abs().max()) <= 2 * LR, k
        moved += int(not torch.equal(v.detach(), before[k]))
    assert moved == len(before)  # AdamW moved every parameter


def test_train_step_runs_no_kernel(monkeypatch):
    """The differentiated forward takes the plain attention on every block;
    the kernel entry is never called, and use_kernel is restored after."""
    def kernel(*a, **k):
        raise AssertionError("a kernel entry ran under the train step")

    monkeypatch.setattr(port_nn, "flash_attention_fused_qkv", kernel)
    ours, _ = _pair("da")
    assert all(b.use_kernel for b in ours.net.encoder.blocks)
    loss = make_train_step(ours, adamw(ours.net.parameters(), LR))(*_batch(56))
    assert torch.isfinite(loss) and all(b.use_kernel for b in ours.net.encoder.blocks)


def test_sharded_train_demo_and_beit_aux_threading(monkeypatch):
    """sharded_train_demo on DA-V2 and BEiT (its cached bias stack threaded
    in: built once, by make_aux, not again inside the step); the cached and
    the inline (aux=None) BEiT steps give the same loss."""
    ours, _ = _pair("da")
    assert np.isfinite(sharded_train_demo(ours, batch=2, image_hw=(56, 56)))
    beit, _ = _pair("beit")
    calls = {"n": 0}
    orig = beit_family.compute_bias_stack

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(beit_family, "compute_bias_stack", counting)
    images, targets = _batch(96)
    aux = beit._get_aux((6, 6))
    assert calls["n"] == 1
    state = {k: v.clone() for k, v in beit.net.state_dict().items()}
    loss_cached = float(make_train_step(beit, adamw(beit.net.parameters(), LR))(images, targets, aux))
    assert calls["n"] == 1
    beit.net.load_state_dict(state)
    loss_inline = float(make_train_step(beit, adamw(beit.net.parameters(), LR))(images, targets, None))
    assert abs(loss_cached - loss_inline) < 1e-5 * max(1.0, abs(loss_inline))


@pytest.mark.parametrize("family", ["beit", "swinv2"])
def test_runner_threads_the_cached_aux(family, monkeypatch):
    """BatchParallelRunner's forward takes the facade's per-grid aux, built
    once (BEiT: one bias-stack build, by make_aux) and equal to the
    facade's own forward; a mesh wider than the world is refused."""
    model, _ = _pair(family)
    calls = {"n": 0}
    orig = beit_family.compute_bias_stack

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(beit_family, "compute_bias_stack", counting)
    side = FAMILIES[family][4]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, side, side, 3)).astype(np.float32))
    runner = BatchParallelRunner(model)
    out = runner(x)
    assert model._aux_cache and calls["n"] == (1 if family == "beit" else 0)
    assert torch.equal(out, runner(x)) and calls["n"] == (1 if family == "beit" else 0)
    assert torch.equal(out, model.forward(x.permute(0, 3, 1, 2)))
    with pytest.raises(ValueError, match="mesh data axis 2 != world size 1"):
        BatchParallelRunner(model, mesh=make_mesh(2, data_parallel=2))


# -- checkpoints --------------------------------------------------------------


def _fresh(seed_state):
    model = make_depthanythingv2_dpt(64, 1, 4, (8, 16, 32, 64), (8, 8), 16, device=DEVICE)
    model.net.load_state_dict(seed_state)
    return model, adamw(model.net.parameters(), LR)


def _train(model, optimizer, images, targets, n):
    step = make_train_step(model, optimizer)
    return [float(step(images, targets)) for _ in range(n)]


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    state = _pair("da")[0].net.state_dict()
    images, targets = finetune_demo.synthetic_scene(np.random.default_rng(3), 2, (28, 28))
    m_full, o_full = _fresh(state)
    losses_full = _train(m_full, o_full, images, targets, 6)

    m, o = _fresh(state)
    losses_a = _train(m, o, images, targets, 3)
    path = ck.save_train_state(str(tmp_path / "ckpts"), 3, m.net, o)
    assert path.endswith("step_3") and ck.latest_step(str(tmp_path / "ckpts")) == 3
    m2, o2 = _fresh(state)  # fresh templates: the state comes from the file
    _, _, step = ck.restore_train_state(str(tmp_path / "ckpts"), m2.net, o2)
    assert step == 3
    losses_b = _train(m2, o2, images, targets, 3)
    np.testing.assert_allclose(losses_full, losses_a + losses_b, rtol=1e-6)
    for (k, a), b in zip(m_full.net.named_parameters(), m2.net.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_checkpoint_keep_prunes_and_latest(tmp_path):
    model, optimizer = _fresh(_pair("da")[0].net.state_dict())
    d = str(tmp_path / "prune")
    assert ck.list_steps(d) == [] and ck.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_train_state(d, model.net, optimizer)
    for s in (1, 2, 3, 4):
        ck.save_train_state(d, s, model.net, optimizer, keep=2)
    assert ck.list_steps(d) == [3, 4]
    assert sorted(os.listdir(d)) == ["step_3", "step_4"]  # no temporary folder left behind


# -- two gloo ranks -------------------------------------------------------------


def _dp_rank(rank, world_size, workdir):
    """One rank of the two-rank test: the runner on a batch of 4; a restore
    of a world-1 checkpoint (checked exactly); one data-parallel step on
    this rank's half of the batch (loss and gradients kept); a world-2
    checkpoint and rank 0's state for the world-1 restore."""
    torch.manual_seed(0)
    d = np.load(os.path.join(workdir, "inputs.npz"))
    model, optimizer = _fresh(torch.load(os.path.join(workdir, "init.pt")))
    depth = BatchParallelRunner(model, mesh=make_mesh(2, data_parallel=2))(torch.from_numpy(d["frames"]))
    _, _, step = ck.restore_train_state(os.path.join(workdir, "ck1"), model.net, optimizer)
    saved = torch.load(os.path.join(workdir, "ck1", f"step_{step}", ck.STATE_FILE), weights_only=True)
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    mine = shard_batch((torch.from_numpy(d["images"]), torch.from_numpy(d["targets"])), rank, world_size)
    loss = make_train_step(model, optimizer)(*mine)
    grads = _grads(model.net)
    ck.save_train_state(os.path.join(workdir, "ck2"), step + 1, model.net, optimizer)
    if rank == 0:
        torch.save({"depth": depth, "loss": loss, "grads": grads, "state": model.net.state_dict(),
                    "opt": optimizer.state_dict()}, os.path.join(workdir, "rank0.pt"))


def test_two_gloo_ranks_match_one_process(tmp_path):
    """The runner over two ranks equals one process's runner; the
    data-parallel step's loss and gradients equal the full-batch step's
    (1e-5 / 1e-4 relative); a world-1 checkpoint restores on two ranks and
    theirs restores in one process, exactly."""
    init = _pair("da")[0].net.state_dict()
    torch.save(init, tmp_path / "init.pt")
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    images, targets = finetune_demo.synthetic_scene(rng, 2, (56, 56))
    np.savez(tmp_path / "inputs.npz", frames=frames, images=images, targets=targets)
    model, optimizer = _fresh(init)
    _train(model, optimizer, images, targets, 2)
    ck.save_train_state(str(tmp_path / "ck1"), 2, model.net, optimizer)

    spawn(_dp_rank, 2, str(tmp_path), device_type="cpu")
    got = torch.load(tmp_path / "rank0.pt", weights_only=True)

    single = BatchParallelRunner(_fresh(init)[0])(torch.from_numpy(frames))
    np.testing.assert_allclose(got["depth"].numpy(), single.numpy(), rtol=2e-5, atol=2e-5)

    loss = _train(model, optimizer, images, targets, 1)[0]  # one process, the full batch
    assert abs(float(got["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    grads = _grads(model.net)
    bad = {k: v for k, v in _grad_errors(got["grads"], grads).items() if v > GRAD_RTOL}
    assert not bad, bad

    m2, o2 = _fresh(init)
    _, _, step = ck.restore_train_state(str(tmp_path / "ck2"), m2.net, o2)
    assert step == 3 and ck.list_steps(str(tmp_path / "ck2")) == [3]
    for k, v in m2.net.state_dict().items():
        assert torch.equal(v, got["state"][k]), k
    for s_ours, s_theirs in zip(o2.state_dict()["state"].values(), got["opt"]["state"].values()):
        assert all(torch.equal(s_ours[k], s_theirs[k]) for k in s_theirs)


# -- the fine-tune demo -------------------------------------------------------


def test_finetune_demo_converges_and_resumes(tmp_path, capsys):
    assert finetune_demo.main(["-d", DEVICE, "--steps", "30"]) == 0
    out = capsys.readouterr().out
    assert "CONVERGED" in out and "eval: abs_rel=" in out
    d = str(tmp_path / "ck")
    assert finetune_demo.main(["-d", DEVICE, "--steps", "6", "--ckpt_dir", d, "--save_every", "3"]) in (0, 1)
    assert ck.list_steps(d) == [3, 6]
    assert finetune_demo.main(["-d", DEVICE, "--steps", "9", "--ckpt_dir", d, "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {d} step 6" in out and "RESUMED OK" in out
