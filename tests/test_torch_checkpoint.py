"""The port's checkpoint loading against the JAX package's, on the CPU:

- each converter of `utils/checkpoint.py` on the same reference-named torch
  state dicts: the same tree structure, leaves bit-equal;
- `factory.load_audiollm` (train.yaml, final.pt, global_cmvn) and
  `factory.load_llm` (the port reads the HF dir's safetensors itself, single
  file and sharded; JAX goes through transformers) from a synthetic
  reference checkpoint dir (tests/test_full_checkpoint_e2e.py builds it);
- `config.from_reference_train_yaml` and `config.load_reference_app_yaml`
  (tests/test_factory.py's YAML): the dataclass trees equal;
- `factory.build_system_from_reference(quantize_llm_bits=8)`: int8 bytes
  equal, scales within the 2e-7 of tests/test_torch_weights.py (XLA may
  rewrite amax / 127 as amax * (1/127)), every other leaf bit-equal;
- the port-native format: a save/load round trip of a system and of a tree
  with bfloat16, tuple and None leaves, and `bin/convert_ckpt.py`;
- the committed index `freeze_omni_tpu_torch/assets/tiny_s2s/chunks.json`
  gives the orbax tree leaf for leaf, bit-exact, with the same config; the
  chunk index on streamed and nested zstd frames;
- `frontend/chunker.OfflineChunker` against the JAX numpy path (loud bins
  within 1e-4, tests/test_torch_frontend.py's rule);
- `utils/metrics` on a few strings.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg
from freeze_omni_tpu.frontend import chunker as jchunker
from freeze_omni_tpu.utils import checkpoint as jckpt
from freeze_omni_tpu.utils import factory as jfactory
from freeze_omni_tpu.utils import metrics as jmetrics
from freeze_omni_tpu_torch import config as tcfg
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.bin import convert_ckpt
from freeze_omni_tpu_torch.frontend.chunker import OfflineChunker
from freeze_omni_tpu_torch.frontend.wav import read_wav
from freeze_omni_tpu_torch.utils import checkpoint as tckpt
from freeze_omni_tpu_torch.utils import factory as tfactory
from freeze_omni_tpu_torch.utils import metrics as tmetrics
from freeze_omni_tpu_torch.utils import safetensors as tsafe
from freeze_omni_tpu_torch.utils.tokenizer import ByteTokenizer
from tests.test_full_checkpoint_e2e import (_make_audiollm_ckpt,
                                            _make_codec_ckpt,
                                            _make_decoder_ckpt, _make_hf_llm)
from tests.test_torch_frontend import assert_fbank_close

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_ASSET = os.path.abspath(os.path.join(ROOT, "freeze_omni_tpu", "assets",
                                         "tiny_s2s"))
COPY = os.path.join(ROOT, "freeze_omni_tpu_torch", "assets", "tiny_s2s")


def paths(tree, prefix=""):
    """{path: leaf} with each container's kind in the path, so two trees
    with the same keys but other containers differ."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(paths(v, f"{prefix}/{type(tree).__name__}{i}"))
        return out
    return {prefix: tree}


def host(tree):
    """A tree of tensors, JAX arrays or numpy arrays -> numpy leaves."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return weights.to_numpy(tree)
    return np.asarray(tree)


def assert_trees_equal(got, want, scale_rtol=None):
    g, w = paths(host(got)), paths(host(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        if scale_rtol is not None and k.endswith("/scale") \
                and k[:-len("scale")] + "w_q" in w:   # an int8 leaf's scale
            np.testing.assert_allclose(g[k], w[k], rtol=scale_rtol, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """A complete synthetic reference checkpoint dir: audiollm (train.yaml,
    global_cmvn, final.pt), an HF Qwen2 dir, decoder and codec."""
    d = tmp_path_factory.mktemp("ref")
    _make_audiollm_ckpt(d)
    _make_hf_llm(d)
    _make_decoder_ckpt(d)
    _make_codec_ckpt(d)
    return d


def _codec_with_encoder():
    """A reference-named codec checkpoint with the encoder branch, and
    weight-norm (weight_g / weight_v) pairs in the generator. Conversion
    does not look at shapes, so they are small and arbitrary."""
    cfg = tcfg.CodecConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                           resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3),), n_code_groups=2,
                           residual_layers=2, global_code_num=2)
    rng = np.random.RandomState(3)

    def t(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32))

    def conv(sd, name, weight_norm=False):
        if weight_norm:
            sd[f"{name}.weight_g"] = t(4, 1, 1)
            sd[f"{name}.weight_v"] = t(4, 3, 5)
        else:
            sd[f"{name}.weight"] = t(4, 3, 5)
        sd[f"{name}.bias"] = t(4)

    gen, quant, enc = {}, {}, {}
    for sd, wn in ((gen, True), (enc, False)):
        conv(sd, "conv_pre", wn)
        for i in range(2):
            conv(sd, f"ups.{i}", wn)
            for grp in ("convs1", "convs2"):
                for j in range(2):
                    conv(sd, f"resblocks.{i}.{grp}.{j}", wn)
    conv(gen, "conv_post", True)
    conv(enc, "conv_post")
    for i in range(2):
        enc[f"normalize.{i}.weight"] = t(6)
        enc[f"normalize.{i}.bias"] = t(6)
    for j in (0, 2, 4):
        conv(enc, f"GlobalTokenEncoder.conv.{j}")
    enc["GlobalTokenEncoder.fn.0.weight"] = t(8, 5)
    enc["GlobalTokenEncoder.fn.0.bias"] = t(8)
    for k in ("weight", "bias", "running_mean", "running_var"):
        enc[f"GlobalTokenEncoder.fn.2.{k}"] = t(8)
    for base in ("quantizer_modules", "quantizer_modules2"):
        for g in range(2):
            quant[f"{base}.{g}.embedding.weight"] = t(16, 4)
    for g in range(2):
        quant[f"quantizer_modules_globaltokens.{g}.embedding.weight"] = t(8, 4)
    return {"generator": gen, "quantizer": quant, "encoder": enc}, cfg


def _to_jax_cfg(cfg):
    """The same dataclass in the JAX package's config module."""
    cls = getattr(jcfg, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = _to_jax_cfg(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


@pytest.mark.parametrize("part", ["encoder", "adapter", "audiollm", "hf_qwen2",
                                  "speech_decoder", "codec", "codec_encoder"])
def test_converter_matches_jax(ref_dir, part):
    if part in ("encoder", "adapter", "audiollm"):
        sd = tckpt.load_torch_state_dict(str(ref_dir / "audiollm" / "final.pt"))
        acfg = tcfg.from_reference_train_yaml(
            tcfg.read_yaml(str(ref_dir / "audiollm" / "train.yaml")))
        cfg, args = {"encoder": (acfg.encoder, ("encoder_user.",)),
                     "adapter": (acfg.adapter, ("adpter_system.",)),
                     "audiollm": (acfg, ())}[part]
        fn = {"encoder": "convert_encoder", "adapter": "convert_adapter",
              "audiollm": "convert_audiollm"}[part]
    elif part == "hf_qwen2":
        sd = tsafe.load_dir(str(ref_dir / "llm"))
        cfg = tfactory.load_llm(str(ref_dir / "llm"),
                                tcfg.AudioLLMConfig())[0]
        fn, args = "convert_hf_qwen2", ()
    elif part == "speech_decoder":
        sd = tckpt.load_torch_state_dict(str(ref_dir / "decoder" / "final.pt"))
        cfg = tfactory.load_speech_decoder(str(ref_dir))[0]
        fn, args = "convert_speech_decoder", ()
    elif part == "codec":
        sd = tckpt.load_torch_state_dict(str(ref_dir / "codec" / "final.pt"))
        cfg = tfactory.load_codec(str(ref_dir))[0]
        fn, args = "convert_codec", ()
    else:
        sd, cfg = _codec_with_encoder()
        fn, args = "convert_codec", ()
    extra = {"with_encoder": True} if part == "codec_encoder" else {}
    got = getattr(tckpt, fn)(sd, cfg, *args, **extra)
    want = getattr(jckpt, fn)(sd, _to_jax_cfg(cfg), *args, **extra)
    assert_trees_equal(got, want)
    if part == "codec_encoder":
        assert "encoder" in got and len(got["quantizer"]["codebooks"]) == 2


def test_load_audiollm_matches_jax(ref_dir):
    """train.yaml -> config, final.pt -> trees, global_cmvn -> the CMVN
    (final.pt's buffers win where it has them, as here)."""
    tc, tp = tfactory.load_audiollm(str(ref_dir))
    jc, jp = jfactory.load_audiollm(str(ref_dir))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert_trees_equal(tp, jp)


def test_load_audiollm_seeds_cmvn_from_the_stats_file(tmp_path):
    """Without global_cmvn buffers in final.pt the stats file's mean and
    inverse stddev seed the normalizer, in both packages."""
    _make_audiollm_ckpt(tmp_path)
    pt = tmp_path / "audiollm" / "final.pt"
    sd = torch.load(pt)
    torch.save({k: v for k, v in sd.items() if "global_cmvn" not in k}, pt)
    _, tp = tfactory.load_audiollm(str(tmp_path))
    _, jp = jfactory.load_audiollm(str(tmp_path))
    assert_trees_equal(tp, jp)
    assert tp["encoder_user"]["cmvn"]["istd"].std() > 0


def test_reference_yaml_configs_match_jax(tmp_path):
    """tests/test_factory.py's train.yaml and app YAML map onto equal
    dataclass trees in both packages."""
    configs = {  # tests/test_factory.py:18's train.yaml
        "input_dim": 80, "output_dim": 4233,
        "encoder_conf": {
            "overview_conf": {"encoder-layer-config": "subsampling-transformer",
                              "encoder-input-dim": 80,
                              "encoder-output-dim": 512},
            "para_conf": {
                "subsampling": {"subsampling-rate": 4,
                                "subsampling-input-dim": 80,
                                "subsampling-output-dim": 512},
                "transformer": {"transformer-attention-dim": 512,
                                "transformer-attention-heads": 8,
                                "transformer-linear-units": 2048,
                                "transformer-num-blocks": 24,
                                "transformer-chunk_size": 4,
                                "transformer-left_chunks": 16,
                                "transformer-pos-enc-class": "rel-enc",
                                "transformer-input-dim": 512}}},
        "model_conf": {"enc_out_dim": 512, "llm_embed_dim": 3584,
                       "kernel_size": 3, "adpter_type": "subsampling",
                       "llm_head_num": 28, "num_key_value_heads": 4,
                       "predict_usr_state": 4, "chunk_size": 2,
                       "activation_func": "gelu", "norm": "layer"}}
    assert dataclasses.asdict(tcfg.from_reference_train_yaml(configs)) == \
        dataclasses.asdict(jcfg.from_reference_train_yaml(configs))
    y = tmp_path / "app.yaml"
    y.write_text(APP_YAML)
    tc, textra = tcfg.load_reference_app_yaml(str(y))
    jc, jextra = jcfg.load_reference_app_yaml(str(y))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert textra == jextra == {"model_path": "/ckpt", "llm_path": "/llm"}
    assert tc.duplex.vad.threshold == 0.6 and tc.sampling.top_k == 7


APP_YAML = (  # tests/test_factory.py:200's reference app YAML
    "model_path: \"/ckpt\"\n"
    "llm_path: \"/llm\"\n"
    "device: 'cuda:0'\n"
    "audio:\n"
    "  expected_sampling_rate: 16000\n"
    "vad:\n"
    "  use_standalone_vad: true\n"
    "  vad_threshold: 0.6\n"
    "  min_silent_duration_second: 0.4\n"
    "  speech_pad_second: 0.05\n"
    "  vad_history_cache_chunk_cnt: 3\n"
    "audio_feature_gating:\n"
    "  feature_gating_history_size: 12\n"
    "  onset_input_chunk_cache_size: 2\n"
    "  fbank:\n"
    "    expected_audio_chunk_duration_in_sec: 0.224\n"
    "    feat_dim: 80\n"
    "    audio_to_proc_per_step_in_sec: 0.016\n"
    "    step_size_in_sec: 0.008\n"
    "    context_duration_in_sec: 0.032\n"
    "inference_control:\n"
    "  top_k: 7\n"
    "  top_p: 0.9\n"
    "  temperature: 0.6\n"
    "  default_prompt: \"Be brief.\"\n"
    "dialog_state_decision:\n"
    "  resp_threshold: 0.55\n")


@pytest.mark.parametrize("sharded", [False, True])
def test_safetensors_reader_and_load_llm_match(ref_dir, tmp_path, sharded):
    """The reader gives the tensors `safetensors` gives, names and dtypes
    (bf16 too), from one file or from shards; the port's load_llm equals
    JAX's (transformers) leaf for leaf, with the same LLMConfig."""
    from safetensors.torch import load_file
    from transformers import Qwen2ForCausalLM

    llm = str(ref_dir / "llm")
    if sharded:
        model = Qwen2ForCausalLM.from_pretrained(llm)
        llm = str(tmp_path / "sharded")
        model.to(torch.bfloat16).save_pretrained(llm, max_shard_size="200KB")
        assert os.path.isfile(os.path.join(llm, tsafe.INDEX))
        want = {}
        for name in sorted(set(json.load(open(os.path.join(
                llm, tsafe.INDEX)))["weight_map"].values())):
            want.update(load_file(os.path.join(llm, name)))
    else:
        want = load_file(os.path.join(llm, tsafe.SINGLE))
    got = tsafe.load_dir(llm)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    base = jcfg.AudioLLMConfig()
    tc, tp = tfactory.load_llm(llm, tcfg.AudioLLMConfig())
    if sharded:  # transformers' state dict of a bf16 model is bf16 torch,
        # which the JAX converters cannot turn into numpy; hold the port to
        # the safetensors tensors widened to f32 instead
        assert tp["embed"]["w"].dtype.name == "bfloat16"
        sd32 = {k: v.float() for k, v in want.items()}
        jp = jckpt.convert_hf_qwen2(sd32, _to_jax_cfg(tc))
        assert_trees_equal(jax.tree.map(lambda a: a.astype(np.float32), host(tp)),
                           jp)
        return
    jc, jp = jfactory.load_llm(llm, base)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert_trees_equal(tp, jp)


@pytest.fixture(scope="module")
def int8_systems(ref_dir):
    """(port, JAX) build_system_from_reference at quantize_llm_bits=8."""
    t = tfactory.build_system_from_reference(
        str(ref_dir), str(ref_dir / "llm"), quantize_llm_bits=8, device="cpu")
    j = jfactory.build_system_from_reference(
        str(ref_dir), str(ref_dir / "llm"), quantize_llm_bits=8)
    return t, j


def test_build_system_from_reference_int8_matches_jax(int8_systems):
    (tc, ta, tt, ttok), (jc, ja, jt, jtok) = int8_systems
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert ta["llm"]["layers"]["q"]["w_q"].dtype == torch.int8
    assert ta["llm"]["layers"]["q"]["w_q"].is_contiguous()
    assert_trees_equal(ta, ja, scale_rtol=2e-7)
    assert_trees_equal(tt, jt)
    assert type(ttok).__name__ == type(jtok).__name__ == "ByteTokenizer"


def test_chip_smoke_reference_checkpoint_loads_in_both_packages(tmp_path):
    """chip_smoke.py's reference-format checkpoint (its phase 11c writer,
    here at tiny widths with an f32 LLM): the JAX package's loader, which
    reads the HF dir through transformers, and the port's give the same
    system, with the LLM config of the written config.json."""
    import chip_smoke

    cfg = tcfg.tiny_system()
    model_path, llm_path = chip_smoke.write_reference_checkpoint(
        str(tmp_path), cfg, seed=3, device="cpu", llm_dtype=torch.float32)
    tc, ta, tt, _ = tfactory.build_system_from_reference(
        model_path, llm_path, device="cpu")
    jc, ja, jt, _ = jfactory.build_system_from_reference(model_path, llm_path)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.audio_llm.llm.hidden == cfg.audio_llm.llm.hidden
    assert tc.audio_llm.llm.vocab_size == cfg.audio_llm.llm.vocab_size
    assert_trees_equal(ta, ja)
    assert_trees_equal(tt, jt)


def test_native_system_round_trip(int8_systems, ref_dir, tmp_path):
    """save_native_system -> load_native_system gives the same config and
    bit-identical trees; bin/convert_ckpt.py writes the same system."""
    tc, ta, tt, _ = int8_systems[0]
    out = tmp_path / "native"
    tfactory.save_native_system(str(out), tc, ta, tt)
    assert tfactory.is_native_system(str(out))
    assert not tfactory.is_native_system(JAX_ASSET)   # orbax, not ours
    c, a, t, tok = tfactory.load_native_system(str(out), device="cpu")
    assert c == tc
    assert_trees_equal(a, ta)
    assert_trees_equal(t, tt)
    assert isinstance(tok, ByteTokenizer)
    conv = tmp_path / "converted"
    convert_ckpt.main(["--model_path", str(ref_dir), "--llm_path",
                       str(ref_dir / "llm"), "--out", str(conv)])
    c2, a2, t2, _ = tfactory.load_native_system(str(conv), device="cpu")
    assert c2 == tc
    assert_trees_equal(a2, ta)
    assert_trees_equal(t2, tt)


def test_save_native_keeps_the_tree(tmp_path):
    """Dicts, lists, tuples and None come back as they went in; bf16, int8
    and f32 leaves keep their bytes; the same tree gives the same file."""
    import ml_dtypes

    rng = np.random.RandomState(0)
    tree = {"a": {"w": rng.randn(3, 4).astype(np.float32),
                  "q": rng.randint(-127, 127, (5,)).astype(np.int8)},
            "l": [rng.randn(2).astype(ml_dtypes.bfloat16),
                  (np.arange(3, dtype=np.int32), None)],
            "t": torch.arange(4, dtype=torch.bfloat16)}
    p1, p2 = tmp_path / "one.npz", tmp_path / "two.npz"
    tckpt.save_native(str(p1), tree)
    tckpt.save_native(str(p2), tree)
    assert p1.read_bytes() == p2.read_bytes()
    back = tckpt.load_native(os.path.relpath(p1))   # a relative path reads
    assert isinstance(back["l"], list) and isinstance(back["l"][1], tuple)
    assert back["l"][1][1] is None
    assert back["t"].dtype.name == "bfloat16"
    assert_trees_equal(back, tree)


def test_committed_copy_equals_the_orbax_tree():
    """freeze_omni_tpu_torch/assets/tiny_s2s (scripts/export_tiny_s2s_torch.py)
    gives the trained tiny system bit for bit from the orbax files' zstd
    frames, with the same config, and loads as a port-native system."""
    got = tckpt._load_chunk_index(os.path.join(COPY, "chunks.json"))
    want = jckpt.load_native(os.path.join(JAX_ASSET, "params"))
    assert_trees_equal(got, want)
    assert tfactory.is_native_system(COPY)
    _, audiollm, tts, _ = tfactory.load_native_system(COPY, device="cpu")
    assert_trees_equal({"audiollm": audiollm, "tts": tts}, want)
    with open(os.path.join(COPY, "config.json"), "rb") as f, \
            open(os.path.join(JAX_ASSET, "config.json"), "rb") as g:
        assert f.read() == g.read()
    tc = tcfg.load_system_config(os.path.join(COPY, "config.json"))
    jc = jcfg.load_system_config(os.path.join(JAX_ASSET, "config.json"))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_chunk_index_reads_streamed_and_nested_zstd_frames(tmp_path):
    """_save_chunk_index / _load_chunk_index on a tree whose leaves are zstd
    frames without a recorded content size (as a streaming writer leaves
    them), some nested in another frame, with magic bytes in between; a
    leaf no frame holds is an error naming it."""
    import zstandard

    rng = np.random.RandomState(4)
    tree = {"w": rng.randn(64, 33).astype(np.float32),
            "l": [rng.randint(-127, 127, (300,)).astype(np.int8),
                  (np.zeros(5, np.float32), None)]}

    def stream(raw):
        c = zstandard.ZstdCompressor(write_content_size=False).compressobj()
        return c.compress(raw) + c.flush()

    def frame(a):
        return stream(np.ascontiguousarray(a).tobytes())

    src = tmp_path / "orbax"
    (src / "d").mkdir(parents=True)
    nested = stream(frame(tree["l"][0]) + b"\x28\xb5\x2f\xfd junk")
    (src / "d" / "a").write_bytes(b"\x28\xb5\x2f\xfd" + frame(tree["w"]) + nested)
    (src / "b").write_bytes(frame(tree["l"][1][0]))
    index = tmp_path / "copy" / "chunks.json"
    index.parent.mkdir()
    tckpt._save_chunk_index(str(index), tree, str(src))
    back = tckpt._load_chunk_index(str(index))
    assert isinstance(back["l"][1], tuple) and back["l"][1][1] is None
    assert_trees_equal(back, tree)
    (src / "b").unlink()
    with pytest.raises(ValueError, match="l/1/0"):
        tckpt._load_chunk_index(str(index))


def test_chunk_index_refuses_a_leaf_split_across_frames(tmp_path):
    """A leaf whose bytes two zstd frames hold between them is an error
    naming it, not a silent partial read."""
    import zstandard

    w = np.random.RandomState(5).randn(64, 33).astype(np.float32)
    raw = w.tobytes()
    c = zstandard.ZstdCompressor()
    src = tmp_path / "orbax"
    src.mkdir()
    (src / "a").write_bytes(c.compress(raw[:4096]) + c.compress(raw[4096:]))
    index = tmp_path / "copy" / "chunks.json"
    index.parent.mkdir()
    tckpt._save_chunk_index(str(index), {"w": w}, str(src))
    with pytest.raises(ValueError, match="single zstd frame .* holds w"):
        tckpt._load_chunk_index(str(index))


def test_only_the_committed_copy_is_read_through_a_chunk_index(tmp_path):
    """A chunk index anywhere but freeze_omni_tpu_torch/assets/tiny_s2s is
    not a port-native system: a native dir needs its params.npz."""
    other = tmp_path / "tiny"
    other.mkdir()
    for name in ("config.json", "chunks.json"):
        (other / name).write_bytes(open(os.path.join(COPY, name), "rb").read())
    assert tfactory.is_native_system(COPY)
    assert not tfactory.is_native_system(str(other))
    with pytest.raises(FileNotFoundError):
        tfactory.load_native_system(str(other), device="cpu")


def test_native_system_without_a_tokenizer_refuses_a_real_vocab(tmp_path):
    """A real-vocab native system with no tokenizer/ copy and no HF dir
    would decode through the ByteTokenizer into empty text: an error."""
    cfg = tcfg.tiny_system()
    cfg = dataclasses.replace(cfg, audio_llm=dataclasses.replace(
        cfg.audio_llm, llm=dataclasses.replace(cfg.audio_llm.llm,
                                               vocab_size=5000)))
    out = tmp_path / "native"
    tfactory.save_native_system(str(out), cfg, {}, {})
    with pytest.raises(RuntimeError, match="vocab_size=5000"):
        tfactory.load_native_system(str(out), device="cpu")


def test_offline_chunker_matches_the_jax_numpy_path():
    """Streamed [1, 19, 80] windows of a dev wav: the JAX chunker with its
    native fbank turned off (`_native = None`, then `reset()`)."""
    wav = read_wav(os.path.join(JAX_ASSET, "dev_wavs", "asr_000.wav"))[0]
    t = OfflineChunker()
    j = jchunker.OfflineChunker()
    j._native = None
    j.reset()
    n = t.get_chunk_size()
    assert n == j.get_chunk_size()
    for i in range(0, min(len(wav), 8 * n), n):
        piece = np.zeros(n, np.float32)
        piece[: len(wav[i:i + n])] = wav[i:i + n]
        a, b = t.process(piece), j.process(piece)
        assert a.shape == b.shape == (1, 19, 80)
        assert_fbank_close(a, b)


def test_metrics_match_jax():
    pairs = [("hu ja ke wa", "hu ja ke"), ("Hello, World!", "hello world"),
             ("你好 世界", "你好")]
    for char_level in (True, False):
        assert tmetrics.corpus_score(pairs, char_level) == \
            jmetrics.corpus_score(pairs, char_level)
    for golds, hyp in ((["The Answer"], "answer is 42"), (["ja", "ke"], "ke"),
                       (["the"], "anything")):
        for fn in ("qa_contains", "qa_exact_match", "qa_f1"):
            assert getattr(tmetrics, fn)(golds, hyp) == \
                getattr(jmetrics, fn)(golds, hyp)
    assert tmetrics.cer("abcd", "abd") == jmetrics.cer("abcd", "abd") == 0.25
