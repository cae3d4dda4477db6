"""The port's generation layer against the JAX package's, on the CPU, and
the port's independence of JAX.

Greedy streams are compared under the rule of ``test_torch_model.py``:
wherever JAX's top-2 logit gap exceeds 0.05 the port picks JAX's token.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models.generation import Llama as JLlama
from clusterfusion_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import GenStats, Llama
from clusterfusion_tpu_torch.models.sampling import sample, sample_top_p
from clusterfusion_tpu_torch.models.tokenizer import (ByteTokenizer,
                                                      load_tokenizer)

ROOT = Path(__file__).resolve().parents[1]
GAP = 0.05


def test_stream_generate_matches_jax():
    jcfg, tcfg = JConfig.tiny(max_seq_len=64), LlamaConfig.tiny(max_seq_len=64)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    jeng = JLlama(jp, jcfg, JByteTokenizer(), fused=True)
    teng = Llama(params_from_numpy(jax.tree.map(np.asarray, jp)), tcfg,
                 ByteTokenizer(), fused=True)
    prompt = teng.tokenizer.encode("hello, world", bos=True, eos=False)
    n = 6
    jt = list(jeng.stream_generate(prompt, n, temperature=0.0))
    tt = list(teng.stream_generate(prompt, n, temperature=0.0))
    assert len(tt) == n and teng.stats.gen_tokens == n
    assert teng.stats.prompt_tokens == len(prompt)
    assert 0 < teng.stats.prefill_s <= teng.stats.total_s
    # JAX's top-2 gaps along JAX's own stream
    kc, vc = jmodel.init_cache(jcfg)
    lg, kc, vc = jmodel.prefill(jp, kc, vc, jnp.asarray(prompt, jnp.int32),
                                jcfg)
    gaps = [np.diff(np.sort(np.asarray(lg[-1])))[-1]]
    for i, t in enumerate(jt[:-1]):
        lg, kc, vc = jmodel.decode_step(jp, kc, vc, jnp.asarray(t, jnp.int32),
                                        jnp.asarray(len(prompt) + i,
                                                    jnp.int32), jcfg)
        gaps.append(np.diff(np.sort(np.asarray(lg)))[-1])
    for i in range(n):
        if gaps[i] > GAP:
            assert tt[i] == jt[i], (i, tt, jt, gaps)
        if tt[i] != jt[i]:
            break
    assert sum(g > GAP for g in gaps) >= 3


def test_stream_generate_eager_and_eos():
    cfg = LlamaConfig.tiny(max_seq_len=32)
    eng = Llama.synthetic(cfg, seed=1, fused=False, device="cpu")
    assert eng.device.type == "cpu" and not eng.fused
    out = list(eng.stream_generate([1, 2, 3], 4, temperature=0.8, top_p=0.9,
                                   seed=5))
    assert len(out) <= 4 and all(0 <= t < cfg.vocab_size for t in out)
    with pytest.raises(ValueError):
        list(eng.stream_generate([1] * 30, 4))


def test_use_cluster_fusion_env(monkeypatch):
    cfg = LlamaConfig.tiny(n_layers=1)
    monkeypatch.setenv("USE_CLUSTER_FUSION", "false")
    assert not Llama.synthetic(cfg, device="cpu").fused
    monkeypatch.setenv("USE_CLUSTER_FUSION", "true")
    assert Llama.synthetic(cfg, device="cpu").fused


def test_byte_tokenizer_matches_jax():
    t, j = load_tokenizer("bytes"), JByteTokenizer()
    s = "héllo ∑"
    assert t.encode(s, bos=True, eos=True) == j.encode(s, bos=True, eos=True)
    assert t.decode(t.encode(s, True, False)) == s
    assert (t.bos_id, t.eos_id, t.pad_id, t.n_words) == (256, 257, 258, 259)


def test_sample_top_p_masks_the_tail():
    # probabilities 0.5, 0.3, 0.15, 0.05: top_p=0.6 keeps the first two
    probs = torch.tensor([0.15, 0.5, 0.05, 0.3])
    logits = torch.log(probs)
    gen = torch.Generator().manual_seed(0)
    seen = {int(sample_top_p(logits, 1.0, 0.6, gen)) for _ in range(200)}
    assert seen == {1, 3}
    seen = {int(sample_top_p(logits, 1.0, 0.0, gen)) for _ in range(50)}
    assert seen == {1}                          # the first token always kept
    assert int(sample(logits, 0.0)) == 1        # temperature 0: greedy


def test_gen_stats():
    assert GenStats(3, 10, 2.0).tokens_per_s == 5.0
    assert GenStats().tokens_per_s == 0.0


def test_synthetic_defaults_to_cuda():
    cfg = LlamaConfig.tiny(n_layers=1)
    if torch.cuda.is_available():
        assert Llama.synthetic(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Llama.synthetic(cfg)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "clusterfusion_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "clusterfusion_tpu"), (f, mod)


def test_chat_cli(capsys):
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--device", "cpu", "--max_gen_len", "3",
               "--temperature", "0", "--max_seq_len", "64"])
    out = capsys.readouterr().out
    assert "fused=True" in out and "tokens/sec" in out
    for flags in (["--synthetic", "--quant", "int8"], ["--synthetic", "--kv_int8"],
                  ["--synthetic", "--spec_draft", "x"], []):
        with pytest.raises(SystemExit, match="not yet ported"):
            chat.main(flags)
