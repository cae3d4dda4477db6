"""Mistral's sliding window on the port's tensor- and sequence-parallel
decode steps, against the JAX package's, on the CPU.

The JAX side runs once per module in two subprocesses, side by side, on a
virtual 8-device CPU mesh.  The first takes ``LlamaConfig.tiny(
max_seq_len=64, sliding_window=24)`` with ``head_group=1`` (JAX's
``tests/test_parallel.py::test_windowed_sp_decode_matches_single_device``
geometry), a 44-token prefill, then two decode steps (pos 44 and 45)
through ``make_sharded_decode_step`` at tp 2 (kernel 6 with its default
bound), ``make_sp_sharded_decode_step`` at tp 2 x sp 2 and tp 1 x sp 4
(kernel 6 in partials mode with each shard's bound) and
``make_sharded_decode_step(fused_collectives=True)`` at tp 2 (the stack
kernel in interpret mode).  At sp 4 the window's bound (global row 21 at
pos 44, 22 at pos 45) leaves shard 0 (rows 0-15) wholly below the window,
cuts shard 1 (16-31), holds shard 2 (32-47) inside it, where the token is
folded and appended, and shard 3 empty; at sp 2 it cuts shard 0 and holds
shard 1.  The second subprocess runs JAX's ``_fused_decoder_layer`` in
interpret mode, partials mode with window ``WINDOW``, at the bounds of
``BOUNDS`` (below row 0, inside, at ``SEQ``, above it) with the token
folded and not, over a random cache.

The port's ranks run as processes of this file (gloo through a file in
the test's temporary directory): the tp 2 runs in a group of two, the sp
runs in a group of four, each holding its logits and cache slices against
JAX's at ``tests/test_parallel.py``'s tolerances (logits atol 0.05 + rtol
0.02, caches atol 0.05; the prefilled rows exact), and a one-process group
holding the three steps against the port's own ``decode_step(fused=
True)``.  Kernel 6's plain twin in partials mode is held against JAX's
layer at ``tests/test_torch_kv8_parallel.py``'s partials tolerances; with
nothing in the window and nothing folded both give the empty state
exactly.  NaN below the bound reaches no output of the twin, and a bound
at or below row 0 gives the bits of no window.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import _close, _env, _load_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW, PROMPT_LEN = 24, 44
STEPS = ((9, 44), (4, 45))          # (token, pos) of the two decode steps
CFG = dict(max_seq_len=64, sliding_window=WINDOW)
# name: (mesh, fused_collectives)
RUNS = {"tp2": (dict(tp=2), False), "tp2fc": (dict(tp=2), True),
        "tp2sp2": (dict(tp=2, sp=2), False), "tp1sp4": (dict(sp=4), False)}
# the rank processes: one gloo group per world size, its runs in turn
GROUPS = {"world2": ["tp2", "tp2fc"], "world4": ["tp2sp2", "tp1sp4"],
          "world1": []}
# kernel 6's layer, cached rows and window bounds (the cache's own rows)
LAYER, SEQ = 1, 40
BOUNDS = {"below_row_0": -5, "inside": 13, "at_seq": SEQ, "above_seq": SEQ + 7}

JAX_COMMON = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from clusterfusion_tpu.config import KernelConfig, LlamaConfig, MeshConfig
from clusterfusion_tpu.models import llama as model


def bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a
"""

JAX_STEPS = JAX_COMMON + r"""
import functools
from jax.experimental.pallas import tpu as pltpu
from clusterfusion_tpu.parallel import (build_mesh, shard_params,
                                        cache_shardings, cache_shardings_2d,
                                        make_sharded_decode_step,
                                        make_sp_sharded_decode_step)

PROMPT_LEN, STEPS, CFG, RUNS = %r
cfg = LlamaConfig.tiny(**CFG)
params = model.init_params(cfg, jax.random.PRNGKey(0), head_group=1)
kc, vc = model.init_cache(cfg)
prompt = (jnp.arange(PROMPT_LEN, dtype=jnp.int32) * 5 + 3) %% cfg.vocab_size
_, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
out = {"k_prefill": bits(kc), "v_prefill": bits(vc)}
for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["param/" + "/".join(k.key for k in path)] = bits(leaf)
fused = functools.partial(make_sharded_decode_step, fused_collectives=True,
                          interpret=pltpu.InterpretParams())
for name, (mesh_kw, fc) in RUNS.items():
    mcfg = MeshConfig(**mesh_kw)
    mesh = build_mesh(mcfg, devices=jax.devices()[:mcfg.n_devices])
    if mcfg.sp > 1:
        make, shardings = make_sp_sharded_decode_step, cache_shardings_2d
    else:
        make = fused if fc else make_sharded_decode_step
        shardings = cache_shardings
    sp = shard_params(params, cfg, mesh)
    k = jax.device_put(kc, shardings(mesh))
    v = jax.device_put(vc, shardings(mesh))
    step = make(cfg, mesh)
    for i, (tok, pos) in enumerate(STEPS):
        lg, k, v = step(sp, k, v, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(pos, jnp.int32))
        out[f"{name}/logits{i}"] = np.asarray(lg, np.float32)
        out[f"{name}/k{i}"], out[f"{name}/v{i}"] = bits(k), bits(v)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
""" % ((PROMPT_LEN, STEPS, CFG, RUNS),)

JAX_LAYERS = JAX_COMMON + r"""
from clusterfusion_tpu.ops import decoder_layer as jdl

CFG, LAYER, SEQ, WINDOW, BOUNDS = %r
cfg = LlamaConfig.tiny(**CFG)
out = {}
rng = np.random.default_rng(25)
L, kv, hd, h = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
g = cfg.n_heads // cfg.kv_heads
ins = {"x": rng.standard_normal((1, h)), "res": rng.standard_normal((1, h)),
       "rms_w": rng.standard_normal((L, 1, h)) * 0.1 + 1.0,
       "k": rng.standard_normal((L, kv, cfg.max_seq_len, hd)),
       "v": rng.standard_normal((L, kv, cfg.max_seq_len, hd))}
ins = {k: jnp.asarray(v, jnp.bfloat16) for k, v in ins.items()}
for k, v in ins.items():
    out[f"in/{k}"] = bits(v)
cos_t, sin_t = model.rope_table(cfg)
cos, sin = cos_t[SEQ:SEQ + 1], sin_t[SEQ:SEQ + 1]
out["in/cos"], out["in/sin"] = bits(cos), bits(sin)
lw = model.init_params(cfg, jax.random.PRNGKey(3), head_group=1)["layers"]
for name in ("wqkv_f", "wo_f"):
    out[f"in/{name}"] = bits(lw[name])
for bound, lo in BOUNDS.items():
    for fold in (0, 1):
        acc, ml, res, k_new, v_new = jdl._fused_decoder_layer(
            ins["x"], ins["res"], ins["rms_w"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], ins["k"], ins["v"], SEQ, LAYER, group=g,
            head_dim=hd, rope_style=cfg.rope_style, fuse_residual=True,
            eps=cfg.norm_eps, kcfg=KernelConfig(), interpret=True,
            emit_partials=True, fold_current=fold, window=WINDOW,
            window_lo=lo)
        out[f"{bound}/fold{fold}/acc"] = np.asarray(acc)
        out[f"{bound}/fold{fold}/ml"] = np.asarray(ml)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
""" % ((CFG, LAYER, SEQ, WINDOW, BOUNDS),)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """(steps file, layers file): the two JAX subprocesses, side by side."""
    d = tmp_path_factory.mktemp("jax_window_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=8").strip()
    paths = [d / "steps.npz", d / "layers.npz"]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(path)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=flags))
        for script, path in zip((JAX_STEPS, JAX_LAYERS), paths)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "JAX_REF_OK" in so, \
            f"stdout:\n{so}\nstderr:\n{se}"
    return paths


@pytest.fixture(scope="module")
def rank_logs(jax_refs, tmp_path_factory):
    """Each rank group's processes, all groups at once; {group: [(return
    code, output) per rank]}."""
    from clusterfusion_tpu_torch.config import MeshConfig
    procs = {}
    for group, runs in GROUPS.items():
        world = MeshConfig(**RUNS[runs[0]][0]).n_devices if runs else 1
        store = tmp_path_factory.mktemp(group) / "store"
        procs[group] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), group,
             str(jax_refs[0]), str(store), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, env=_env(OMP_NUM_THREADS="1"))
            for rank in range(world)]
    logs = {}
    try:
        for group, ps in procs.items():
            outs = [p.communicate(timeout=300)[0] for p in ps]
            logs[group] = [(p.returncode, out) for p, out in zip(ps, outs)]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return logs


def _group_ok(rank_logs, group, tag):
    for rank, (rc, out) in enumerate(rank_logs[group]):
        assert rc == 0 and f"{tag} {rank}" in out, \
            f"rank {rank} of {group}:\n{out}"


@pytest.mark.parametrize("run", list(RUNS))
def test_windowed_sharded_step_matches_jax(rank_logs, run):
    """Each rank's logits and cache slices after both windowed steps
    against JAX's (the module's tolerances; the prefilled rows exact)."""
    group = next(g for g, runs in GROUPS.items() if run in runs)
    _group_ok(rank_logs, group, f"RUN_OK {run}")


def test_windowed_one_process_group_matches_single_device_step(rank_logs):
    """In a one-process group the tp step (both kinds) and the sp step
    give ``decode_step(fused=True)``'s windowed logits and rows."""
    _group_ok(rank_logs, "world1", "RUN_OK world1")


def test_shard_window_lo_gives_every_shard_case():
    """The sp step's shard bound (``shard_window_lo``) at sp 4 over the
    64-row cache at pos 44 and 45: shard 0 wholly below the window (no
    live split), shard 1 cut by it, shard 2 inside it (it owns pos), shard
    3 empty; at sp 2 shard 0 is cut and shard 1 inside."""
    from clusterfusion_tpu_torch.ops.decoder_layer import live_splits
    from clusterfusion_tpu_torch.parallel.sp_decode import shard_window_lo
    assert shard_window_lo(44, 0, 16) is None
    for pos in (44, 45):
        cases = []
        for sp in (4, 2):
            cap = 64 // sp
            for start in range(0, 64, cap):
                seq = min(max(pos - start, 0), cap)
                lo = shard_window_lo(pos, WINDOW, start)
                assert lo == pos + 1 - WINDOW - start
                first, live = live_splits(seq, 8, WINDOW, lo)
                owner = start <= pos < start + cap
                cases.append("empty" if seq == 0 else "below" if live == 0
                             else "inside" if lo <= 0 else "cut")
                assert first == min(max(lo, 0), seq)
                assert not owner or cases[-1] == "inside"
        assert cases == ["below", "cut", "inside", "empty", "cut", "inside"]


def _layer_inputs(arrays):
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy

    def t(key):
        return tensor_from_numpy(arrays[f"in/{key}"], device="cpu")

    cfg = LlamaConfig.tiny(**CFG)
    args = [t(k) for k in ("x", "res", "rms_w", "cos", "sin", "wqkv_f",
                           "wo_f", "k", "v")]
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, fuse_residual=True,
              eps=cfg.norm_eps, emit_partials=True)
    return args, kw


@pytest.mark.parametrize("fold", [0, 1])
@pytest.mark.parametrize("bound", list(BOUNDS))
def test_windowed_partials_match_jax(jax_refs, bound, fold):
    """Kernel 6's twin in partials mode with window ``WINDOW`` from the
    bound ``window_lo`` against JAX's ``_fused_decoder_layer`` (interpret
    mode): m at rtol 1e-5 + atol 1e-3, l at rtol 1e-2 + atol 1e-3, acc at
    rtol 2e-2 + atol 5e-2; with nothing in the window and nothing folded
    (a bound at or above ``SEQ``, fold 0) the empty state exactly: m =
    -1e30, l = 0, acc = 0."""
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    _, arrays = _load_ref(jax_refs[1])
    args, kw = _layer_inputs(arrays)
    acc, ml, _, _, _ = tdl._fused_decoder_layer(
        *args, SEQ, LAYER, **kw, fold_current=fold, window=WINDOW,
        window_lo=BOUNDS[bound])
    want_acc = arrays[f"{bound}/fold{fold}/acc"]
    want_ml = arrays[f"{bound}/fold{fold}/ml"]
    np.testing.assert_allclose(ml[0].numpy(), want_ml[0], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(ml[1].numpy(), want_ml[1], rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(acc.numpy(), want_acc, rtol=2e-2, atol=5e-2)
    if BOUNDS[bound] >= SEQ and not fold:
        assert np.all(want_ml[0] == np.float32(-1e30))
        assert np.all(ml[0].numpy() == np.float32(-1e30))
        assert not ml[1].any() and not acc.any()
        assert not want_ml[1].any() and not want_acc.any()


@pytest.mark.parametrize("mode", ["full", "append", "partials"])
def test_twin_reads_nothing_below_the_bound(mode):
    """NaN in every cached row below the bound (and at and above ``SEQ``)
    leaves the twin's outputs finite and equal to those over finite rows
    there, in each mode; a bound at or below row 0 gives the bits of no
    window."""
    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    cfg = LlamaConfig.tiny(**CFG)
    lw = tmodel.init_params(cfg, seed=5, head_group=1, device="cpu")["layers"]
    gen = torch.Generator().manual_seed(25)
    kc = torch.randn((cfg.n_layers, cfg.kv_heads, 64, cfg.head_dim_),
                     generator=gen).bfloat16()
    vc = torch.randn(kc.shape, generator=gen).bfloat16()
    x = torch.randn((1, cfg.hidden_dim), generator=gen).bfloat16()
    res = torch.randn((1, cfg.hidden_dim), generator=gen).bfloat16()
    cos, sin = tmodel.rope_row(cfg, SEQ)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, fuse_residual=True,
              eps=cfg.norm_eps, append_kv=mode == "append",
              emit_partials=mode == "partials")

    def run(k, v, **w):
        out = tdl._fused_decoder_layer(x, res, lw["attn_norm"], cos, sin,
                                       lw["wqkv_f"], lw["wo_f"], k, v, SEQ,
                                       LAYER, **kw, **w)
        return [t for t in out[:5 if mode == "partials" else 4]
                if torch.is_tensor(t)]

    lo = SEQ + 1 - WINDOW
    kn, vn = kc.clone(), vc.clone()
    for c in (kn, vn):
        c[LAYER, :, :lo] = float("nan")
        c[LAYER, :, SEQ:] = float("nan")
    got = run(kn, vn, window=WINDOW)
    want = run(kc.clone(), vc.clone(), window=WINDOW)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    none = run(kc.clone(), vc.clone())
    for bound in (0, -3):
        at_0 = run(kc.clone(), vc.clone(), window=WINDOW, window_lo=bound)
        assert all(torch.equal(a, b) for a, b in zip(at_0, none))
    assert not torch.equal(want[0], none[0])


# --------------------------------------------------------------------------
# One rank (this file run as a script: group, reference, store, rank)
# --------------------------------------------------------------------------


def _run(name, mesh, cfg, full, arrays):
    """One run of ``RUNS`` on this rank: both steps against JAX's."""
    import torch

    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
    from clusterfusion_tpu_torch.parallel import (cache_pspec,
                                                  cache_pspec_2d,
                                                  make_sharded_decode_step,
                                                  make_sp_sharded_decode_step,
                                                  shard_cache, shard_params)
    sp_mode = mesh.shape["sp"] > 1
    spec = cache_pspec_2d() if sp_mode else cache_pspec()
    if sp_mode:
        step = make_sp_sharded_decode_step(cfg, mesh)
    else:
        step = make_sharded_decode_step(cfg, mesh,
                                        fused_collectives=RUNS[name][1])
    params = shard_params(full, cfg, mesh)
    k0 = tensor_from_numpy(arrays["k_prefill"], device="cpu")
    v0 = tensor_from_numpy(arrays["v_prefill"], device="cpu")
    kc, vc = shard_cache(k0, mesh, spec), shard_cache(v0, mesh, spec)
    cap = k0.shape[2]
    where = shard_cache(torch.arange(cap)[None, None, :, None]
                        .expand(1, cfg.kv_heads, cap, 1), mesh,
                        spec)[0, 0, :, 0]
    hist = where < PROMPT_LEN
    for i, (tok, pos) in enumerate(STEPS):
        lg, kc, vc = step(params, kc, vc, tok, pos)
        _close(f"{name} logits{i}", lg, arrays[f"{name}/logits{i}"], 0.05,
               0.02)
        for key, c in (("k", kc), ("v", vc)):
            want = shard_cache(tensor_from_numpy(
                arrays[f"{name}/{key}{i}"], device="cpu"), mesh, spec)
            _close(f"{name} {key} cache after step {i}", c, want, 0.05)
            assert torch.equal(c[:, :, hist], want[:, :, hist])


def _check_world1(mesh, cfg, full, arrays):
    """One process: the three steps against ``decode_step(fused=True)``
    over the same two windowed steps (logits atol 0.05 + rtol 0.02,
    caches 0.05)."""
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
    from clusterfusion_tpu_torch.parallel import (cache_pspec_2d,
                                                  make_sharded_decode_step,
                                                  make_sp_sharded_decode_step,
                                                  shard_cache)
    k0 = tensor_from_numpy(arrays["k_prefill"], device="cpu")
    v0 = tensor_from_numpy(arrays["v_prefill"], device="cpu")
    steps = {"tp": make_sharded_decode_step(cfg, mesh),
             "tp fused": make_sharded_decode_step(cfg, mesh,
                                                  fused_collectives=True),
             "sp": make_sp_sharded_decode_step(cfg, mesh)}
    caches = {"tp": (k0.clone(), v0.clone()),
              "tp fused": (k0.clone(), v0.clone()),
              "sp": tuple(shard_cache(c.clone(), mesh, cache_pspec_2d())
                          for c in (k0, v0))}
    kr, vr = k0.clone(), v0.clone()
    for i, (tok, pos) in enumerate(STEPS):
        ref, kr, vr = tmodel.decode_step(full, kr, vr, tok, pos, cfg,
                                         fused=True)
        for what, step in steps.items():
            lg, k, v = step(full, *caches[what], tok, pos)
            caches[what] = (k, v)
            _close(f"{what} logits{i}", lg, ref.numpy(), 0.05, 0.02)
            _close(f"{what} k cache {i}", k, kr.float().numpy(), 0.05)
            _close(f"{what} v cache {i}", v, vr.float().numpy(), 0.05)


def _rank_main(group, ref, store, rank):
    import torch
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import LlamaConfig, MeshConfig
    from clusterfusion_tpu_torch.models.convert import params_from_numpy
    from clusterfusion_tpu_torch.parallel import build_mesh
    torch.set_num_threads(1)
    runs = GROUPS[group]
    world = MeshConfig(**RUNS[runs[0]][0]).n_devices if runs else 1
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        cfg = LlamaConfig.tiny(**CFG)
        tree, arrays = _load_ref(ref)
        full = params_from_numpy(tree, device="cpu")
        if not runs:
            _check_world1(build_mesh(MeshConfig()), cfg, full, arrays)
            print(f"RUN_OK {group} {rank}", flush=True)
        for name in runs:
            mesh = build_mesh(MeshConfig(**RUNS[name][0]))
            try:
                _run(name, mesh, cfg, full, arrays)
            except AssertionError as e:
                print(f"RUN_FAIL {name} {rank}: {e}", flush=True)
            else:
                print(f"RUN_OK {name} {rank}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
