"""The port's tensor- and sequence-parallel decode on 8-bit KV caches
against the JAX package's, on the CPU.

Where the JAX package runs an 8-bit cache on its multi-chip steps, the
port runs it too: an fp8 e4m3 pair in the tp step (kernel 6 with its
in-kernel append), the tp x sp step (kernel 6 in partials mode) and the
fused tp step (kernel 7's mode 5), an ``Int8KV`` pair in the fused tp step
only (JAX's kernel 6 reads ``k_cache.dtype``, which an ``Int8KV`` pair has
not, so its tp and sp steps raise on one; the port's refuse it by name).

The JAX side runs once per module in two subprocesses, side by side, on a
virtual 8-device CPU mesh: ``LlamaConfig.tiny(max_seq_len=256,
n_kv_heads=4, hidden_dim=512, ffn_dim=1024)`` with ``head_group=1``, a
127-token prefill into each cache kind, then two decode steps at pos 127
and 128 (the second ``Int8KV`` append writes the scale planes' row 1; at
sp 2 the two positions fall on different ranks) through
``make_sharded_decode_step`` at tp 2, ``make_sp_sharded_decode_step`` at
tp 2 x sp 2 and ``make_sharded_decode_step(fused_collectives=True)`` at tp
2 (Pallas in interpret mode), on bf16 weights and, for tp 2 and the fused
tp 2 step on fp8, on ``quantize_llama_params(params, "int8", 128,
lm_head=True)``.  The second subprocess runs ``_fused_decoder_layer``
(interpret mode) on a random fp8 cache, NaN bytes at and above ``SEQ``, at
head groups 1 and 2 in full, append, partials and ``fold_current=0``
modes.

The port's side runs one process per rank (this file run as a script):
the five tp 2 runs in one gloo group of two processes, the tp 2 x sp 2 run
in one of four, each meeting through a file in the test's temporary
directory.  Tolerances: logits atol 0.06 + rtol 0.03
(``tests/test_torch_int8_parallel.py``'s); fp8 rows atol 0.08 + rtol
0.125 (one e4m3 step, ``tests/test_torch_kv8.py``'s); ``Int8KV`` codes
within 1 and scales at rtol 1e-2; the prefilled rows exact.  Kernel 6's
fp8 twin is held against JAX's layer at ``tests/test_torch_layer.py``'s
tolerances (output max 1e-1 and mean 1e-2, residual 2e-2, k/v rows 5e-2;
partials as there), its appended e4m3 bytes equal to JAX's wherever JAX's
are finite (JAX's CPU cast gives NaN above 448; the port saturates).

Which bits an append stores differs between the steps, as in JAX: the tp
steps store e4m3 of the float32 row, the sp step's owner e4m3 of the bf16
row; ``test_fp8_append_rule_both_ways`` holds both rules and finds rows
where they differ.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import _close, _env, _load_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LEN = 127
STEPS = ((9, 127), (4, 128))        # (token, pos) of the two decode steps
CFG = dict(max_seq_len=256, n_kv_heads=4, hidden_dim=512, ffn_dim=1024)
# name: (mesh, cache format, weights, fused_collectives)
RUNS = {
    "tp2_fp8": (dict(tp=2), "fp8", "bf16", False),
    "tp2fc_fp8": (dict(tp=2), "fp8", "bf16", True),
    "tp2fc_int8": (dict(tp=2), "int8", "bf16", True),
    "tp2_fp8_w8": (dict(tp=2), "fp8", "int8", False),
    "tp2fc_fp8_w8": (dict(tp=2), "fp8", "int8", True),
    "tp2sp2_fp8": (dict(tp=2, sp=2), "fp8", "bf16", False),
}
# the rank processes: one gloo group per world size, its runs in turn
GROUPS = {"world2": [r for r, v in RUNS.items() if "sp" not in v[0]],
          "world4": ["tp2sp2_fp8"]}
LAYER, SEQ = 1, 77                  # kernel 6's layer and cached rows
LAYER_MODES = {
    # name: (fuse_residual, append_kv, emit_partials, fold)
    "full": (True, False, False, 1),
    "append": (True, True, False, 1),
    "partials": (True, False, True, 1),
    "fold0": (True, False, True, 0),
}
NAN8 = 0x7F                         # an e4m3fn NaN byte

JAX_COMMON = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from clusterfusion_tpu.config import KernelConfig, LlamaConfig, MeshConfig
from clusterfusion_tpu.models import llama as model
from clusterfusion_tpu.ops.quant import Int8KV


def bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def put(out, key, c):
    if isinstance(c, Int8KV):
        out[key + "/q"], out[key + "/s"] = bits(c.q), bits(c.s)
    else:
        out[key] = bits(c)
"""

JAX_STEPS = JAX_COMMON + r"""
import functools
from jax.experimental.pallas import tpu as pltpu
from clusterfusion_tpu.ops.quant import quantize_llama_params
from clusterfusion_tpu.parallel import (build_mesh, shard_params,
                                        cache_shardings, cache_shardings_2d,
                                        make_sharded_decode_step,
                                        make_sp_sharded_decode_step)

PROMPT_LEN, STEPS, CFG, RUNS = %r
cfg = LlamaConfig.tiny(**CFG)
out = {}
bf = model.init_params(cfg, jax.random.PRNGKey(0), head_group=1)
for path, leaf in jax.tree_util.tree_leaves_with_path(bf):
    out["param/" + "/".join(k.key for k in path)] = bits(leaf)
trees = {"bf16": bf, "int8": quantize_llama_params(bf, "int8", 128,
                                                   lm_head=True)}
prompt = (jnp.arange(PROMPT_LEN, dtype=jnp.int32) * 3 + 1) %% cfg.vocab_size
caches = {}
for fmt, dt in (("fp8", jnp.float8_e4m3fn), ("int8", "int8")):
    kc, vc = model.init_cache(cfg, dtype=dt)
    _, kc, vc = model.prefill(bf, kc, vc, prompt, cfg)
    caches[fmt] = (kc, vc)
    put(out, f"prefill/{fmt}/k", kc)
    put(out, f"prefill/{fmt}/v", vc)
fused = functools.partial(make_sharded_decode_step, fused_collectives=True,
                          interpret=pltpu.InterpretParams())
for name, (mesh_kw, fmt, wts, fc) in RUNS.items():
    mcfg = MeshConfig(**mesh_kw)
    mesh = build_mesh(mcfg, devices=jax.devices()[:mcfg.n_devices])
    params = trees[wts]
    if mcfg.sp > 1:
        make, shardings = make_sp_sharded_decode_step, cache_shardings_2d
    else:
        make = fused if fc else make_sharded_decode_step
        shardings = cache_shardings
    sp = shard_params(params, cfg, mesh)
    k = jax.device_put(caches[fmt][0], shardings(mesh))
    v = jax.device_put(caches[fmt][1], shardings(mesh))
    step = make(cfg, mesh, params=params)
    for i, (tok, pos) in enumerate(STEPS):
        lg, k, v = step(sp, k, v, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(pos, jnp.int32))
        out[f"{name}/logits{i}"] = np.asarray(lg, np.float32)
        put(out, f"{name}/k{i}", k)
        put(out, f"{name}/v{i}", v)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
""" % ((PROMPT_LEN, STEPS, CFG, RUNS),)

JAX_LAYERS = JAX_COMMON + r"""
import ml_dtypes
from clusterfusion_tpu.ops import decoder_layer as jdl

CFG, LAYER, SEQ, LAYER_MODES, NAN8 = %r
cfg = LlamaConfig.tiny(**CFG)
out = {}
rng = np.random.default_rng(11)
L, kv, hd, h = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
g = cfg.n_heads // cfg.kv_heads
ins = {"x": rng.standard_normal((1, h)), "res": rng.standard_normal((1, h)),
       "rms_w": rng.standard_normal((L, 1, h)) * 0.1 + 1.0}
ins = {k: jnp.asarray(v, jnp.bfloat16) for k, v in ins.items()}
# N(0, 1) rows, a tenth scaled into e4m3's denormals (|v| < 0.0137), NaN
# bytes at and above SEQ
vals = rng.standard_normal((2, L, kv, cfg.max_seq_len, hd))
vals[rng.random(vals.shape) < 0.1] *= 0.004
raw = vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
raw[:, :, :, SEQ:] = NAN8
ins["k"], ins["v"] = (jnp.asarray(r.view(ml_dtypes.float8_e4m3fn))
                      for r in raw)
for k, v in ins.items():
    out[f"layer/in/{k}"] = bits(v)
cos_t, sin_t = model.rope_table(cfg)
cos, sin = cos_t[SEQ:SEQ + 1], sin_t[SEQ:SEQ + 1]
out["layer/in/cos"], out["layer/in/sin"] = bits(cos), bits(sin)
for hg in (1, 2):
    lw = model.init_params(cfg, jax.random.PRNGKey(hg), head_group=hg)[
        "layers"]
    for name in ("wqkv_f", "wo_f"):
        out[f"layer/hg{hg}/{name}"] = bits(lw[name])
    for mode, (fuse, append, partials, fold) in LAYER_MODES.items():
        res = jdl._fused_decoder_layer(
            ins["x"], ins["res"], ins["rms_w"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], ins["k"], ins["v"], SEQ, LAYER, group=g, head_dim=hd,
            rope_style=cfg.rope_style, fuse_residual=fuse, eps=cfg.norm_eps,
            kcfg=KernelConfig(), interpret=True, emit_partials=partials,
            fold_current=fold, append_kv=append)
        for i, a in enumerate(res):
            out[f"layer/hg{hg}/{mode}/{i}"] = bits(a)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
""" % ((CFG, LAYER, SEQ, LAYER_MODES, NAN8),)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """(steps file, layers file): the two JAX subprocesses, side by side."""
    d = tmp_path_factory.mktemp("jax_kv8_ref")
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
            outs.append(p.communicate(timeout=900))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "JAX_REF_OK" in so, \
            f"stdout:\n{so}\nstderr:\n{se}"
    return paths


def _fp8(a):
    """An e4m3 array saved as bytes -> a float8_e4m3fn tensor."""
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).view(torch.float8_e4m3fn)


def _cache(arrays, key, fmt):
    """A saved cache as the port's: an fp8 tensor or an ``Int8KV``."""
    import torch

    from clusterfusion_tpu_torch.ops.quant import Int8KV
    if fmt == "int8":
        return Int8KV(torch.from_numpy(arrays[key + "/q"].copy()),
                      torch.from_numpy(arrays[key + "/s"].copy()))
    return _fp8(arrays[key]).clone()


@pytest.fixture(scope="module")
def rank_logs(jax_refs, tmp_path_factory):
    """Each rank group's processes run once; {group: [output per rank]}."""
    from clusterfusion_tpu_torch.config import MeshConfig
    logs = {}
    for group, runs in GROUPS.items():
        world = MeshConfig(**RUNS[runs[0]][0]).n_devices
        store = tmp_path_factory.mktemp(group) / "store"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), group,
             str(jax_refs[0]), str(store), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, env=_env(OMP_NUM_THREADS="1"))
            for rank in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs[group] = [(p.returncode, out) for p, out in zip(procs, outs)]
    return logs


@pytest.mark.parametrize("run", list(RUNS))
def test_kv8_sharded_step_matches_jax(rank_logs, run):
    """Each rank's logits and cache slices after both steps against JAX's
    (the module's tolerances; the prefilled rows exact)."""
    group = next(g for g, runs in GROUPS.items() if run in runs)
    for rank, (rc, out) in enumerate(rank_logs[group]):
        assert rc == 0 and f"RUN_OK {run} {rank}" in out, \
            f"rank {rank} of {run}:\n{out}"


@pytest.mark.parametrize("mode", list(LAYER_MODES))
@pytest.mark.parametrize("hg", [1, 2])
def test_fp8_fused_decoder_layer_matches_jax(jax_refs, hg, mode):
    """Kernel 6's fp8 twin against JAX's ``_fused_decoder_layer`` on the
    same bf16 weights ([L, G, ...], layer 1 read) and random fp8 cache,
    NaN bytes at and above ``SEQ``: the outputs at
    ``tests/test_torch_layer.py``'s tolerances; with the append the new
    e4m3 row's bytes equal JAX's where JAX's are finite, and no other
    byte moves."""
    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    _, arrays = _load_ref(jax_refs[1])
    cfg = LlamaConfig.tiny(**CFG)

    def t(key):
        return tensor_from_numpy(arrays[key], device="cpu")

    k0, v0 = _fp8(arrays["layer/in/k"]), _fp8(arrays["layer/in/v"])
    kc, vc = k0.clone(), v0.clone()
    fuse, append, partials, fold = LAYER_MODES[mode]
    got = tdl._fused_decoder_layer(
        t("layer/in/x"), t("layer/in/res"), t("layer/in/rms_w"),
        t("layer/in/cos"), t("layer/in/sin"), t(f"layer/hg{hg}/wqkv_f"),
        t(f"layer/hg{hg}/wo_f"), kc, vc, SEQ, LAYER,
        group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
        rope_style=cfg.rope_style, fuse_residual=fuse, eps=cfg.norm_eps,
        emit_partials=partials, fold_current=fold, append_kv=append)
    n_out = len(got) - (2 if append else 0)
    want = [arrays[f"layer/hg{hg}/{mode}/{i}"] for i in range(n_out + 2 * append)]

    def err(a, b):
        return float(np.max(np.abs(a.float().numpy() - b.astype(np.float32))))

    if partials:
        acc, ml, res_out, k_new, v_new = got
        np.testing.assert_allclose(ml[0].numpy(), want[1][0], rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(ml[1].numpy(), want[1][1], rtol=1e-2,
                                   atol=1e-3)
        np.testing.assert_allclose(acc.numpy(), want[0], rtol=2e-2,
                                   atol=5e-2)
        want_res, want_k, want_v = want[2:5]
    else:
        out, res_out, k_new, v_new = got[:4]
        assert err(out, want[0]) < 1e-1, "output"
        assert float(np.mean(np.abs(out.float().numpy()
                                    - want[0].astype(np.float32)))) < 1e-2
        want_res, want_k, want_v = want[1:4]
    assert err(res_out, want_res) < 2e-2, "residual"
    assert err(k_new, want_k) < 5e-2, "k_new"
    assert err(v_new, want_v) < 5e-2, "v_new"
    others = torch.ones(kc.shape[2], dtype=torch.bool)
    if append:
        others[SEQ] = False
        for got_c, want_c in ((kc, want[4]), (vc, want[5])):
            row = got_c[LAYER, :, SEQ].view(torch.uint8).numpy()
            jrow = np.asarray(want_c).view(np.uint8)[LAYER, :, SEQ]
            finite = (jrow & 0x7F) != NAN8
            assert finite.mean() > 0.99
            assert np.array_equal(row[finite], jrow[finite])
    for c, c0 in ((kc, k0), (vc, v0)):
        assert torch.equal(c[:, :, others].view(torch.uint8),
                           c0[:, :, others].view(torch.uint8))


def _one_rank_mesh():
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    return Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0),
                groups=dict.fromkeys(AXES))


def test_fp8_append_rule_both_ways():
    """The tp step appends e4m3 of the float32 k and v rows (kernel 6's
    rule, JAX's ``kv_s.astype``), the sp step's owner e4m3 of the bf16
    rows (JAX's ``k_new.astype``): layer 0's appended rows of both steps
    on a one-rank mesh against the two rules, computed apart from the
    steps (the float32 rows from the twin appending into a float32
    cache), and the two rules differ on this input."""
    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    from clusterfusion_tpu_torch.parallel import (make_sharded_decode_step,
                                                  make_sp_sharded_decode_step)
    cfg = LlamaConfig.tiny(**CFG)
    params = tmodel.init_params(cfg, seed=3, head_group=1, device="cpu")
    mesh = _one_rank_mesh()
    fp8 = torch.float8_e4m3fn
    tok, pos = 11, 5
    rows = {}
    for name, make in (("tp", make_sharded_decode_step),
                       ("sp", make_sp_sharded_decode_step)):
        kc, vc = tmodel.init_cache(cfg, device="cpu", dtype=fp8)
        make(cfg, mesh)(params, kc, vc, tok, pos)
        rows[name] = (kc[0, :, pos].view(torch.uint8),
                      vc[0, :, pos].view(torch.uint8))
    lw = params["layers"]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    cos, sin = tmodel.rope_row(cfg, pos)
    k32 = torch.zeros(cfg.n_layers, cfg.kv_heads, cfg.max_seq_len, hd)
    v32 = torch.zeros_like(k32)
    x = params["embed"][[tok]]
    _, _, k_new, v_new, _, _ = tdl._fused_decoder_layer_plain(
        x, torch.zeros_like(x), lw["attn_norm"], cos, sin, lw["wqkv_f"],
        lw["wo_f"], k32, v32, pos, 0, group=g, head_dim=hd,
        rope_style=cfg.rope_style, fuse_residual=True, eps=cfg.norm_eps,
        append_kv=True)
    f32_rule = (k32[0, :, pos].to(fp8).view(torch.uint8),
                v32[0, :, pos].to(fp8).view(torch.uint8))
    bf16_rule = (k_new.to(fp8).view(torch.uint8),
                 v_new.to(fp8).view(torch.uint8))
    for i in range(2):
        assert torch.equal(rows["tp"][i], f32_rule[i])
        assert torch.equal(rows["sp"][i], bf16_rule[i])
        assert (f32_rule[i] != bf16_rule[i]).any()


def test_int8kv_and_mixed_pairs_refused():
    """What JAX cannot run the port refuses by name: an ``Int8KV`` pair in
    kernel 6, in the tp step without ``fused_collectives`` and in the sp
    step, and ``shard_cache`` of one under ``cache_pspec_2d()``; a pair of
    two kinds in kernel 6."""
    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    from clusterfusion_tpu_torch.parallel import (cache_pspec_2d,
                                                  make_sharded_decode_step,
                                                  make_sp_sharded_decode_step,
                                                  shard_cache)
    cfg = LlamaConfig.tiny(**CFG)
    params = tmodel.init_params(cfg, seed=0, head_group=1, device="cpu")
    mesh = _one_rank_mesh()
    k8, v8 = tmodel.init_cache(cfg, device="cpu", dtype="int8")
    f8, _ = tmodel.init_cache(cfg, device="cpu", dtype=torch.float8_e4m3fn)
    bf, _ = tmodel.init_cache(cfg, device="cpu")
    lw = params["layers"]
    cos, sin = tmodel.rope_row(cfg, 3)
    x = params["embed"][[7]]

    def layer(kc, vc):
        return tdl._fused_decoder_layer(
            x, x, lw["attn_norm"], cos, sin, lw["wqkv_f"], lw["wo_f"], kc,
            vc, 3, 1, group=1, head_dim=cfg.head_dim_,
            rope_style=cfg.rope_style, fuse_residual=True, eps=cfg.norm_eps)

    with pytest.raises(NotImplementedError, match="kernel 6.*take none"):
        layer(k8, v8)
    for make in (make_sharded_decode_step, make_sp_sharded_decode_step):
        with pytest.raises(NotImplementedError, match="take none"):
            make(cfg, mesh)(params, k8, v8, 7, 3)
    assert (k8.q == 0).all() and (v8.q == 0).all()     # nothing appended
    with pytest.raises(NotImplementedError, match="over sp"):
        shard_cache(k8, mesh, cache_pspec_2d())
    for kc, vc in ((k8, f8), (f8, bf), (bf, v8)):
        with pytest.raises(ValueError, match="one kind"):
            layer(kc, vc)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_cache_int8kv_slices_tile_the_pair(tp):
    """``shard_cache`` of an ``Int8KV`` pair under ``cache_pspec()``: each
    rank's slice is an ``Int8KV`` of its kv heads' rows and scale planes,
    and the ranks' slices put together give the pair; an fp8 cache's
    slices tile it too."""
    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.ops.quant import Int8KV
    from clusterfusion_tpu_torch.parallel import Mesh, shard_cache
    from clusterfusion_tpu_torch.parallel.mesh import AXES
    cfg = LlamaConfig.tiny(**CFG)
    k8, _ = tmodel.init_cache(cfg, device="cpu", dtype="int8")
    gen = torch.Generator().manual_seed(tp)
    k8.q.copy_(torch.randint(-127, 128, k8.q.shape, generator=gen))
    k8.s.copy_(torch.rand(k8.s.shape, generator=gen))
    f8 = torch.randn(k8.q.shape, generator=gen).to(torch.float8_e4m3fn)
    meshes = [Mesh(shape=dict(dict.fromkeys(AXES, 1), tp=tp),
                   coords=dict(dict.fromkeys(AXES, 0), tp=r),
                   groups=dict.fromkeys(AXES)) for r in range(tp)]
    parts = [shard_cache(k8, m) for m in meshes]
    assert all(isinstance(p, Int8KV) for p in parts)
    assert all(p.q.shape[1] == cfg.kv_heads // tp == p.s.shape[1]
               for p in parts)
    assert torch.equal(torch.cat([p.q for p in parts], dim=1), k8.q)
    assert torch.equal(torch.cat([p.s for p in parts], dim=1), k8.s)
    f8_parts = [shard_cache(f8, m) for m in meshes]
    assert torch.equal(torch.cat(f8_parts, dim=1).view(torch.uint8),
                       f8.view(torch.uint8))


# --------------------------------------------------------------------------
# One rank group (this file run as a script: group, reference, store, rank)
# --------------------------------------------------------------------------


def _check_cache(errs, what, got, want, hist):
    """A cache slice after a step against JAX's (the module's tolerances:
    fp8 values at atol 0.08 + rtol 0.125, ``Int8KV`` codes within 1 and
    scales at rtol 1e-2; the rows ``hist`` exact)."""
    import torch

    from clusterfusion_tpu_torch.ops.quant import Int8KV
    try:
        if isinstance(got, Int8KV):
            dq = (got.q.int() - want.q.int()).abs().max().item()
            assert dq <= 1, f"{what}: codes {dq} apart"
            np.testing.assert_allclose(got.s.numpy(), want.s.numpy(),
                                       rtol=1e-2, err_msg=what)
            assert torch.equal(got.q[:, :, hist], want.q[:, :, hist]), what
            L, H = got.s.shape[:2]          # the scales per position
            s_got = got.s.reshape(L, H, -1)[:, :, :hist.numel()]
            s_want = want.s.reshape(L, H, -1)[:, :, :hist.numel()]
            assert torch.equal(s_got[:, :, hist], s_want[:, :, hist]), what
        else:
            _close(what, got, want, 0.08, 0.125)
            assert torch.equal(got[:, :, hist].view(torch.uint8),
                               want[:, :, hist].view(torch.uint8)), what
    except AssertionError as e:
        errs.append(str(e))


def _run(name, mesh, cfg, trees, arrays, errs):
    """One run of ``RUNS`` on this rank: both steps, every check's failure
    recorded in ``errs`` (the steps' collectives run on every rank)."""
    import torch

    from clusterfusion_tpu_torch.parallel import (cache_pspec, cache_pspec_2d,
                                                  make_sharded_decode_step,
                                                  make_sp_sharded_decode_step,
                                                  shard_cache, shard_params)
    mesh_kw, fmt, wts, fc = RUNS[name]
    params = shard_params(trees[wts], cfg, mesh)
    sp_mode = mesh.shape["sp"] > 1
    spec = cache_pspec_2d() if sp_mode else cache_pspec()
    if sp_mode:
        step = make_sp_sharded_decode_step(cfg, mesh)
    else:
        step = make_sharded_decode_step(cfg, mesh, fused_collectives=fc)
    kc = shard_cache(_cache(arrays, f"prefill/{fmt}/k", fmt), mesh, spec)
    vc = shard_cache(_cache(arrays, f"prefill/{fmt}/v", fmt), mesh, spec)
    k_in, v_in = kc, vc
    cap = cfg.max_seq_len
    where = shard_cache(torch.arange(cap)[None, None, :, None]
                        .expand(1, cfg.kv_heads, cap, 1), mesh,
                        spec)[0, 0, :, 0]
    hist = where < PROMPT_LEN
    for i, (tok, pos) in enumerate(STEPS):
        lg, kc, vc = step(params, kc, vc, tok, pos)
        try:
            _close(f"{name} logits{i}", lg, arrays[f"{name}/logits{i}"],
                   0.06, 0.03)
        except AssertionError as e:
            errs.append(str(e))
        for c, key in ((kc, "k"), (vc, "v")):
            want = shard_cache(_cache(arrays, f"{name}/{key}{i}", fmt), mesh,
                               spec)
            _check_cache(errs, f"{name} {key} cache after step {i}", c,
                         want, hist)
    if kc is not k_in or vc is not v_in:        # updated in place
        errs.append(f"{name}: the step returned other caches")


def _rank_main(group, ref, store, rank):
    import torch
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import LlamaConfig, MeshConfig
    from clusterfusion_tpu_torch.models.convert import params_from_numpy
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    from clusterfusion_tpu_torch.parallel import build_mesh
    torch.set_num_threads(1)
    runs = GROUPS[group]
    mcfg = MeshConfig(**RUNS[runs[0]][0])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=mcfg.n_devices, rank=rank)
    try:
        mesh = build_mesh(mcfg)
        cfg = LlamaConfig.tiny(**CFG)
        tree, arrays = _load_ref(ref)
        bf = params_from_numpy(tree, device="cpu")
        trees = {"bf16": bf}
        if any(RUNS[r][2] == "int8" for r in runs):
            trees["int8"] = quantize_llama_params(bf, "int8", 128,
                                                  lm_head=True)
        for name in runs:
            errs = []
            _run(name, mesh, cfg, trees, arrays, errs)
            if errs:
                print(f"RUN_FAIL {name} {rank}: " + "; ".join(errs),
                      flush=True)
            else:
                print(f"RUN_OK {name} {rank}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
