"""The port's int4 tensor- and sequence-parallel decode against the JAX
package's, on the CPU, in both int4 modes (W4A8, ``KernelConfig.
int4_w4a8``, and the exact product).

The JAX side runs once per module in a subprocess on a virtual 8-device
CPU mesh, with JAX's own quantized tp setup (``tests/test_parallel.py``'s
``test_quantized_tp_and_sp_decode_matches_single_device``):
``LlamaConfig.tiny(max_seq_len=64, n_kv_heads=4, hidden_dim=512,
ffn_dim=1024)`` with ``head_group=1``, ``quantize_llama_params(params,
"int4", 128, lm_head=True)`` (int4 projections, an int8 LM head), a
20-token prefill, then two decode steps (pos 20 and 21) through
``make_sharded_decode_step`` at tp 2, ``make_sp_sharded_decode_step`` at
tp 2 x sp 2 and ``make_sharded_decode_step(fused_collectives=True)`` at tp
2 (the stack kernel with the ring all-reduces inside it, Pallas in
interpret mode), each with ``KernelConfig(int4_w4a8=True)`` and
``(int4_w4a8=False)``.  It also runs ``_fused_decoder_layer`` (interpret
mode) on an int4 ``QuantizedTensor`` pair at head groups 1 and 2, in full,
append, partials and ``fold_current=0`` modes, in both int4 modes, and
writes its parameters, the prefilled caches, the layer's inputs and every
output to a file.

The port's side quantizes the same bf16 parameters itself (its codes and
scales must equal JAX's bit for bit) and runs one process per rank (this
file run as a script) in a gloo group that meets through a file in the
test's temporary directory: ``shard_params`` of the int4 tree,
``shard_cache``, the same steps, held against JAX's at JAX's tolerance for
this test: logits atol 0.06 + rtol 0.03, caches atol 0.05, the prefilled
rows exact.  The W4A8 steps are JAX's function too: kernel 6 quantizes
each head group's o (here one kv head of two query heads) and the normed
row, the FFN is exact in both packages, and the fused step quantizes the
down product per f-block of the rank's shard in both.  W4A8 is
discontinuous, and XLA on the CPU keeps JAX's exact bf16(code * s) in
float32 (``tests/test_torch_int4.py``), so both are held at that same
tolerance, which is loose enough for either.  Kernel 6's int4 twin is held
against JAX's layer at ``tests/test_torch_layer.py``'s tolerances (output
max 1e-1 and mean 1e-2, residual 2e-2, k/v rows 5e-2; partials as there,
but for the exact mode's row maxima: 2**-8 of the score, JAX's CPU weights
being unrounded).
The spec tree of an int4 tree must equal JAX's node for node, the ranks'
int4 slices must tile every leaf, and a cut that would split a scale
group raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import _close, _env, _load_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LEN = 20
STEPS = ((9, 20), (4, 21))          # (token, pos) of the two decode steps
MODES = {"tp2": dict(tp=2), "tp2sp2": dict(tp=2, sp=2), "tp2fc": dict(tp=2)}
FUSED = ("tp2fc",)                  # fused_collectives=True
INT4 = {"w4a8": True, "exact": False}   # KernelConfig.int4_w4a8
CFG = dict(max_seq_len=64, n_kv_heads=4, hidden_dim=512, ffn_dim=1024)
LAYER, SEQ = 1, 37                  # kernel 6's layer and cached rows
LAYER_MODES = {
    # name: (fuse_residual, append_kv, emit_partials, fold)
    "full": (True, False, False, 1),
    "append": (True, True, False, 1),
    "partials": (True, False, True, 1),
    "fold0": (True, False, True, 0),
}
GARBAGE = 1e3                       # cache rows at and above SEQ

JAX_REF = r"""
import functools
import json
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from clusterfusion_tpu.config import KernelConfig, LlamaConfig, MeshConfig
from clusterfusion_tpu.models import llama as model
from clusterfusion_tpu.ops import decoder_layer as jdl
from clusterfusion_tpu.ops.quant import quantize_llama_params
from clusterfusion_tpu.parallel import (build_mesh, shard_params,
                                        cache_shardings, cache_shardings_2d,
                                        make_sharded_decode_step,
                                        make_sp_sharded_decode_step)
from clusterfusion_tpu.parallel.sharding import param_pspecs

PROMPT_LEN, STEPS, CFG, LAYER, SEQ, LAYER_MODES, GARBAGE, INT4 = %r
PART = sys.argv[2]                  # "steps" or "layers"


def bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    if hasattr(tree, "kind"):
        ndim = len(tuple(tree.s))
        return {prefix + "q": list(tree.q), prefix + "s": list(tree.s),
                prefix + "fields": [tree.kind, tree.axis %% ndim - ndim,
                                    tree.group_size]}
    return {prefix: list(tree)}


cfg = LlamaConfig.tiny(**CFG)
out = {}
bf = model.init_params(cfg, jax.random.PRNGKey(0), head_group=1)
for path, leaf in jax.tree_util.tree_leaves_with_path(bf):
    out["param/" + "/".join(k.key for k in path)] = bits(leaf)
params = quantize_llama_params(bf, "int4", 128, lm_head=True)
for name in ("wqkv_f", "wo_f", "w13", "w2"):
    out[f"quant/{name}/q"] = bits(params["layers"][name].q)
    out[f"quant/{name}/s"] = bits(params["layers"][name].s)
out["quant/lm_head/q"] = bits(params["lm_head"].q)
out["quant/lm_head/s"] = bits(params["lm_head"].s)
out["pspecs"] = np.array(json.dumps(flat(param_pspecs(cfg, 2, params))))
kc, vc = model.init_cache(cfg)
prompt = (jnp.arange(PROMPT_LEN, dtype=jnp.int32) * 3 + 1) %% cfg.vocab_size
_, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
out["k_prefill"], out["v_prefill"] = bits(kc), bits(vc)
fused = functools.partial(make_sharded_decode_step, fused_collectives=True,
                          interpret=pltpu.InterpretParams())
for i4, a8 in INT4.items() if PART == "steps" else ():
    kcfg = KernelConfig(int4_w4a8=a8)
    for name, mcfg, make, shardings in (
            ("tp2", MeshConfig(tp=2), make_sharded_decode_step,
             cache_shardings),
            ("tp2sp2", MeshConfig(tp=2, sp=2), make_sp_sharded_decode_step,
             cache_shardings_2d),
            ("tp2fc", MeshConfig(tp=2), fused, cache_shardings)):
        mesh = build_mesh(mcfg, devices=jax.devices()[:mcfg.n_devices])
        sp = shard_params(params, cfg, mesh)
        k = jax.device_put(kc, shardings(mesh))
        v = jax.device_put(vc, shardings(mesh))
        step = make(cfg, mesh, kcfg=kcfg, params=params)
        for i, (tok, pos) in enumerate(STEPS):
            lg, k, v = step(sp, k, v, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32))
            key = f"{name}/{i4}"
            out[f"{key}/logits{i}"] = np.asarray(lg, np.float32)
            out[f"{key}/k{i}"], out[f"{key}/v{i}"] = bits(k), bits(v)

# kernel 6 on an int4 QuantizedTensor pair, head groups 1 and 2
rng = np.random.default_rng(11)
L, kv, hd, h = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
g = cfg.n_heads // cfg.kv_heads
ins = {"x": rng.standard_normal((1, h)), "res": rng.standard_normal((1, h)),
       "rms_w": rng.standard_normal((L, 1, h)) * 0.1 + 1.0}
cache = rng.standard_normal((2, L, kv, cfg.max_seq_len, hd))
cache[:, :, :, SEQ:] = GARBAGE
ins["k"], ins["v"] = cache
ins = {k: jnp.asarray(v, jnp.bfloat16) for k, v in ins.items()}
for k, v in ins.items():
    out[f"layer/in/{k}"] = bits(v)
cos_t, sin_t = model.rope_table(cfg)
cos, sin = cos_t[SEQ:SEQ + 1], sin_t[SEQ:SEQ + 1]
out["layer/in/cos"], out["layer/in/sin"] = bits(cos), bits(sin)
for hg in (1, 2) if PART == "layers" else ():
    lw = quantize_llama_params(
        model.init_params(cfg, jax.random.PRNGKey(hg), head_group=hg),
        "int4", 128)["layers"]
    for name in ("wqkv_f", "wo_f"):
        out[f"layer/hg{hg}/{name}/q"] = bits(lw[name].q)
        out[f"layer/hg{hg}/{name}/s"] = bits(lw[name].s)
    for i4, a8 in INT4.items():
        for mode, (fuse, append, partials, fold) in LAYER_MODES.items():
            res = jdl._fused_decoder_layer(
                ins["x"], ins["res"], ins["rms_w"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], ins["k"], ins["v"], SEQ, LAYER, group=g,
                head_dim=hd, rope_style=cfg.rope_style, fuse_residual=fuse,
                eps=cfg.norm_eps, kcfg=KernelConfig(int4_w4a8=a8),
                interpret=True, emit_partials=partials, fold_current=fold,
                append_kv=append)
            for i, a in enumerate(res):
                out[f"layer/hg{hg}/{i4}/{mode}/{i}"] = bits(a)
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
""" % ((PROMPT_LEN, STEPS, CFG, LAYER, SEQ, LAYER_MODES, GARBAGE, INT4),)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX run's file: its two parts (the steps, the layers) run side
    by side in two processes, their arrays merged."""
    tmp = tmp_path_factory.mktemp("jax_int4_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=8").strip()
    parts = ("steps", "layers")
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_REF, str(tmp / f"{part}.npz"), part],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=flags)) for part in parts]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "JAX_REF_OK" in out, \
            f"stdout:\n{out}\nstderr:\n{err}"
    merged = {}
    for part in parts:
        with np.load(tmp / f"{part}.npz") as data:
            merged.update({k: data[k] for k in data.files})
    path = tmp / "ref.npz"
    np.savez(path, **merged)
    return path


def _int4_tree(tree):
    """The port's int4 tree of the JAX run's bf16 parameters (numpy)."""
    from clusterfusion_tpu_torch.models.convert import params_from_numpy
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    return quantize_llama_params(params_from_numpy(tree, device="cpu"),
                                 "int4", 128, lm_head=True)


def test_int4_tree_matches_jax(jax_ref):
    """The port's quantization of the same bf16 tree gives JAX's codes and
    scales bit for bit (an int8 LM head), so both sides step the same
    weights."""
    tree, arrays = _load_ref(jax_ref)
    params = _int4_tree(tree)
    assert params["lm_head"].kind == "int8"
    for name in ("wqkv_f", "wo_f", "w13", "w2", "lm_head"):
        w = params[name] if name == "lm_head" else params["layers"][name]
        for part in ("q", "s"):
            want = arrays[f"quant/{name}/{part}"]
            got = getattr(w, part).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                f"{name}.{part}"


def _run_ranks(ref, tmp_path, mode: str, i4: str):
    """Start one process per rank of ``mode``; each must print RANK_OK."""
    from clusterfusion_tpu_torch.config import MeshConfig
    world = MeshConfig(**MODES[mode]).n_devices
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, i4, str(ref),
         str(store), str(rank)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_env(OMP_NUM_THREADS="1")) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {rank}" in out, \
            f"rank {rank} of {mode} ({i4}):\n{out}"


@pytest.mark.parametrize("i4", list(INT4))
@pytest.mark.parametrize("mode", list(MODES))
def test_int4_sharded_step_matches_jax(jax_ref, tmp_path, mode, i4):
    _run_ranks(jax_ref, tmp_path, mode, i4)


@pytest.mark.parametrize("mode", list(LAYER_MODES))
@pytest.mark.parametrize("i4", list(INT4))
@pytest.mark.parametrize("hg", [1, 2])
def test_int4_fused_decoder_layer_matches_jax(jax_ref, hg, i4, mode):
    """Kernel 6's int4 twin against JAX's ``_fused_decoder_layer`` on the
    same QuantizedTensor pair (stacked [L, G, ...], layer 1 read), the
    cache's rows at and above ``SEQ`` holding garbage; with the append the
    new row lands at ``SEQ`` and no other row moves."""
    import torch

    from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
    _, arrays = _load_ref(jax_ref)
    cfg = LlamaConfig.tiny(**CFG)

    def t(key):
        return tensor_from_numpy(arrays[key], device="cpu")

    w = {name: QuantizedTensor(t(f"layer/hg{hg}/{name}/q"),
                               t(f"layer/hg{hg}/{name}/s"), "int4", -2, 128,
                               -2)
         for name in ("wqkv_f", "wo_f")}
    assert w["wqkv_f"].shape[1] == cfg.kv_heads // hg
    k0, v0 = t("layer/in/k"), t("layer/in/v")
    kc, vc = k0.clone(), v0.clone()
    fuse, append, partials, fold = LAYER_MODES[mode]
    got = tdl._fused_decoder_layer(
        t("layer/in/x"), t("layer/in/res"), t("layer/in/rms_w"),
        t("layer/in/cos"), t("layer/in/sin"), w["wqkv_f"], w["wo_f"], kc, vc,
        SEQ, LAYER, group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
        rope_style=cfg.rope_style, fuse_residual=fuse, eps=cfg.norm_eps,
        kcfg=KernelConfig(int4_w4a8=INT4[i4]), emit_partials=partials,
        fold_current=fold, append_kv=append)
    want = [arrays[f"layer/hg{hg}/{i4}/{mode}/{i}"].astype(np.float32)
            for i in range(len(got) - (2 if append else 0))]

    def err(a, b):
        return float(np.max(np.abs(a.float().numpy() - b)))

    if partials:
        acc, ml, res_out, k_new, v_new = got
        # exact: XLA on the CPU keeps JAX's weights bf16(code * s) in
        # float32, up to half a bf16 step (2**-9) from the port's, so q and
        # k, and their dot, may part by up to 2**-8 of the score
        np.testing.assert_allclose(ml[0].numpy(), want[1][0],
                                   rtol=1e-5 if INT4[i4] else 2.0 ** -8,
                                   atol=1e-3)
        np.testing.assert_allclose(ml[1].numpy(), want[1][1], rtol=1e-2,
                                   atol=1e-3)
        np.testing.assert_allclose(acc.numpy(), want[0], rtol=2e-2,
                                   atol=5e-2)
        want_res, want_k, want_v = want[2:5]
    else:
        out, res_out, k_new, v_new = got[:4]
        assert err(out, want[0]) < 1e-1, "output"
        assert float(np.mean(np.abs(out.float().numpy() - want[0]))) < 1e-2
        want_res, want_k, want_v = want[1:4]
    assert err(res_out, want_res) < 2e-2, "residual"
    assert err(k_new, want_k) < 5e-2, "k_new"
    assert err(v_new, want_v) < 5e-2, "v_new"
    others = torch.ones(kc.shape[2], dtype=torch.bool)
    if append:
        others[SEQ] = False
        assert torch.equal(kc[LAYER, :, SEQ], k_new.to(kc.dtype))
        assert torch.equal(vc[LAYER, :, SEQ], v_new.to(vc.dtype))
    assert torch.equal(kc[:, :, others], k0[:, :, others])
    assert torch.equal(vc[:, :, others], v0[:, :, others])


def test_int4_layer_modes_differ(jax_ref):
    """The two int4 modes are two functions: kernel 6's W4A8 and exact
    outputs part by more than the tolerance above's mean (so the layer test
    would see a twin that ran the wrong mode), as JAX's do."""
    _, arrays = _load_ref(jax_ref)
    for src in ("jax", "port"):
        if src == "jax":
            a = arrays["layer/hg2/w4a8/full/0"].astype(np.float32)
            b = arrays["layer/hg2/exact/full/0"].astype(np.float32)
        else:
            a, b = (_port_layer(arrays, 2, m).float().numpy()
                    for m in (True, False))
        assert float(np.mean(np.abs(a - b))) > 1e-3, src


def _port_layer(arrays, hg, a8):
    from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
    cfg = LlamaConfig.tiny(**CFG)

    def t(key):
        return tensor_from_numpy(arrays[key], device="cpu")

    w = [QuantizedTensor(t(f"layer/hg{hg}/{n}/q"), t(f"layer/hg{hg}/{n}/s"),
                         "int4", -2, 128, -2) for n in ("wqkv_f", "wo_f")]
    return tdl._fused_decoder_layer(
        t("layer/in/x"), t("layer/in/res"), t("layer/in/rms_w"),
        t("layer/in/cos"), t("layer/in/sin"), *w, t("layer/in/k"),
        t("layer/in/v"), SEQ, LAYER, group=cfg.n_heads // cfg.kv_heads,
        head_dim=cfg.head_dim_, rope_style=cfg.rope_style,
        fuse_residual=True, eps=cfg.norm_eps,
        kcfg=KernelConfig(int4_w4a8=a8))[0]


def test_int4_param_pspecs_match_jax(jax_ref):
    """``param_pspecs(cfg, 2, params)`` of the port's int4 tree equals the
    spec tree JAX's ``param_pspecs`` gives for its own, node for node: the
    group-scale rows cut with the weight (``w2``'s rows over tp)."""
    import json

    from test_torch_int8_parallel import _flat

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.parallel import param_pspecs
    tree, arrays = _load_ref(jax_ref)
    want = json.loads(str(arrays["pspecs"]))
    got = _flat(param_pspecs(LlamaConfig.tiny(**CFG), 2, _int4_tree(tree)))
    assert got == want
    assert got["layers/w2/s"] == [None, "tp", None]
    assert got["layers/wo_f/s"] == [None, "tp", None, None]
    assert got["layers/w13/s"] == [None, None, None, "tp"]
    assert got["layers/w2/fields"][0] == "int4"


@pytest.mark.parametrize("tp,sp", [(2, 1), (4, 1), (2, 2)])
def test_int4_shard_slices_tile_the_whole(tp, sp):
    """The ranks' int4 slices (codes and group scales) put back together
    give every leaf, each rank's codes and scales covering the same k rows;
    a replicated leaf is the tensor itself (no copy)."""
    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    from clusterfusion_tpu_torch.parallel import Mesh, shard_params
    cfg = LlamaConfig.tiny(**CFG)
    params = quantize_llama_params(
        tmodel.init_params(cfg, seed=0, head_group=1, device="cpu"), "int4",
        128, lm_head=True)
    meshes = [Mesh(shape={"tp": tp, "sp": sp}, coords={"tp": t, "sp": s},
                   groups={"tp": None, "sp": None})
              for t in range(tp) for s in range(sp)]
    shards = [shard_params(params, cfg, m) for m in meshes]
    for t in range(tp):          # the sp ranks of one tp rank agree
        for s in range(1, sp):
            a, b = (shards[t * sp + i]["layers"]["w2"] for i in (0, s))
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    axes = {"wqkv_f": 1, "wo_f": 1, "w13": -1, "w2": 1}
    for name, dim in axes.items():
        whole = params["layers"][name]
        parts = [sh["layers"][name] for sh in shards[::sp]]
        assert torch.equal(torch.cat([p.q for p in parts], dim=dim), whole.q)
        assert torch.equal(torch.cat([p.s for p in parts], dim=dim), whole.s)
        for p in parts:
            assert p.kind == "int4" and p.group_size == 128
            # packed rows and scale rows cover the same k rows
            assert p.q.shape[-2] * 2 == p.s.shape[-2] * 128
        assert torch.equal(
            torch.cat([p.dequantize() for p in parts], dim=dim),
            whole.dequantize())
    lm = params["lm_head"]
    parts = [sh["lm_head"] for sh in shards[::sp]]
    assert torch.equal(torch.cat([p.q for p in parts], dim=-1), lm.q)
    assert all(sh["embed"] is params["embed"] for sh in shards)


def test_int4_cut_inside_a_group_raises():
    """A tp whose cut of ``w2``'s rows would split a scale group raises a
    ValueError naming the leaf (ffn 1024 is 8 groups: tp 2 and 4 cut on
    group boundaries, a 16-way cut would not)."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as tmodel
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    from clusterfusion_tpu_torch.parallel import Mesh, shard_params
    cfg = LlamaConfig.tiny(max_seq_len=64, n_kv_heads=16, n_heads=16,
                           head_dim=128, hidden_dim=512, ffn_dim=1024)
    params = quantize_llama_params(
        tmodel.init_params(cfg, seed=0, head_group=1, device="cpu"), "int4",
        128)
    mesh = Mesh(shape={"tp": 16, "sp": 1}, coords={"tp": 0, "sp": 0},
                groups={"tp": None, "sp": None})
    with pytest.raises(ValueError, match=r"w2\.s: axis 1 of \(2, 8, 512\)"):
        shard_params(params, cfg, mesh)


# --------------------------------------------------------------------------
# One rank (this file run as a script: mode, int4 mode, reference, store,
# rank)
# --------------------------------------------------------------------------


def _rank_main(mode, i4, ref, store, rank):
    import torch
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import (KernelConfig, LlamaConfig,
                                                MeshConfig)
    from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
    from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
    from clusterfusion_tpu_torch.parallel import (build_mesh, cache_pspec,
                                                  cache_pspec_2d,
                                                  make_sharded_decode_step,
                                                  make_sp_sharded_decode_step,
                                                  shard_cache, shard_params)
    torch.set_num_threads(1)
    mcfg = MeshConfig(**MODES[mode])
    kcfg = KernelConfig(int4_w4a8=INT4[i4])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=mcfg.n_devices, rank=rank)
    try:
        mesh = build_mesh(mcfg)
        cfg = LlamaConfig.tiny(**CFG)
        tree, arrays = _load_ref(ref)
        params = shard_params(_int4_tree(tree), cfg, mesh)
        assert all(isinstance(params["layers"][k], QuantizedTensor)
                   and params["layers"][k].kind == "int4"
                   for k in ("wqkv_f", "wo_f", "w13", "w2"))
        k0 = tensor_from_numpy(arrays["k_prefill"], device="cpu")
        v0 = tensor_from_numpy(arrays["v_prefill"], device="cpu")
        sp_mode = mcfg.sp > 1
        spec = cache_pspec_2d() if sp_mode else cache_pspec()
        if sp_mode:
            step = make_sp_sharded_decode_step(cfg, mesh, kcfg)
        else:
            step = make_sharded_decode_step(cfg, mesh, kcfg,
                                            fused_collectives=mode in FUSED)
        kc, vc = shard_cache(k0, mesh, spec), shard_cache(v0, mesh, spec)
        cap = k0.shape[2]
        where = shard_cache(torch.arange(cap)[None, None, :, None]
                            .expand(1, cfg.kv_heads, cap, 1), mesh,
                            spec)[0, 0, :, 0]
        hist = where < PROMPT_LEN
        for i, (tok, pos) in enumerate(STEPS):
            lg, kc, vc = step(params, kc, vc, tok, pos)
            key = f"{mode}/{i4}"
            _close(f"logits{i}", lg, arrays[f"{key}/logits{i}"], 0.06, 0.03)
            for name, c in (("k", kc), ("v", vc)):
                want = shard_cache(tensor_from_numpy(
                    arrays[f"{key}/{name}{i}"], device="cpu"), mesh, spec)
                _close(f"{name} cache after step {i}", c, want, 0.05)
                assert torch.equal(c[:, :, hist], want[:, :, hist])
    finally:
        dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4],
               int(sys.argv[5]))
