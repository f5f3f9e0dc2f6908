"""Data-parallel and multi-host training (bin/train.py --coordinator) on the
CPU, against the port's single-process run of the global batch and the JAX
package's loss.

Two gloo CPU "hosts" (tests/_torch_parallel_child.py, one torch thread
each) run bin/train.main with --coordinator, as two machines would, on the
JAX multi-host test's command (--preset tiny --stage state --steps 3
--batch 8 --seed 7): each trains on its 4 rows of the global batch. A jit
over a data-sharded batch computes the global batch's loss; so must the
port: every host prints the same summary (param_checksum included), the
losses equal the single-process run on the global batch (the first within
1e-5 relative, the last within 1e-4), and the first loss equals the JAX
`stage_loss` of the same weights and global batch. The uneven-mask case
trains the align stage on four utterances of the committed ASR dev set,
whose transcripts pad to different mask counts in the two halves of the
batch: there a mean
over each host's rows would miss the global loss, and the hosts match the
single-process run all the same. A run resumed on both hosts from the
checkpoint the uninterrupted run wrote at step 2 continues it. On a host
with two cards (torch.cuda standing in for them), only the CLI's main
starts a process a card; run() trains in the process it was called in.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import tiny_system as jtiny
from freeze_omni_tpu.training import train_step as jts
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.bin import train as ttrain
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.training import data as tdata
from freeze_omni_tpu_torch.training import manifest as tmani
from freeze_omni_tpu_torch.training import train_step as tts
from freeze_omni_tpu_torch.utils.tokenizer import ByteTokenizer
from tests.test_torch_parallel import collect_ranks, start_ranks, stop_ranks

STATE = ["--preset", "tiny", "--stage", "state", "--steps", "3", "--batch", "8",
         "--seed", "7", "--device", "cpu"]
DEV_TSV = os.path.join("freeze_omni_tpu", "assets", "tiny_s2s", "asr_dev.tsv")
ALIGN = ["--preset", "tiny", "--stage", "align", "--steps", "1", "--batch", "4",
         "--seed", "3", "--device", "cpu"]
HOST_KEYS = ("host_id", "rank")


def manifest(tmp) -> str:
    """The first four utterances of the committed ASR dev set (transcripts
    of 11, 11, 11 and 8 bytes: the halves of any batch of the four hold
    different mask counts)."""
    with open(DEV_TSV) as f:
        rows = f.read().splitlines()[:4]
    path = tmp / "train.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def with_flag(argv, flag, value):
    i = argv.index(flag)
    return argv[:i + 1] + [value] + argv[i + 2:]


def hosts(tmp, name, argv):
    return start_ranks({"mode": "train", "hosts": 2, "mesh": [name],
                        "argv": argv}, tmp, world=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: [host 0's result, host 1's]} of the two-host runs,
    {name: out} of the single-process runs, and the align stage's
    manifest."""
    tmp = tmp_path_factory.mktemp("dp")
    ck = str(tmp / "ck")
    align = ALIGN + ["--manifest", manifest(tmp)]
    procs = {"state": hosts(tmp, "state", STATE + ["--ckpt_dir", ck,
                                                    "--save_every", "2"]),
             "align": hosts(tmp, "align", align)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # beside the hosts and the other test workers
    try:
        single = {"state": ttrain.main(STATE), "align": ttrain.main(align)}
        two = {name: collect_ranks(p) for name, p in procs.items()}
        procs["resume"] = hosts(tmp, "resume", with_flag(STATE, "--steps", "1") + [
            "--ckpt_dir", ck, "--save_every", "2", "--resume"])
        two["resume"] = collect_ranks(procs["resume"])
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            stop_ranks(p)
    return ({name: [r[h] for h in (0, 1)] for name, r in two.items()}, single,
            align[-1])


@pytest.mark.parametrize("name", ["state", "align"])
def test_hosts_print_one_summary(runs, name):
    a, b = (r["summary"] for r in runs[0][name])
    assert (a["host_id"], a["rank"], b["host_id"], b["rank"]) == (0, 0, 1, 1)
    assert {k: v for k, v in a.items() if k not in HOST_KEYS} == \
        {k: v for k, v in b.items() if k not in HOST_KEYS}
    assert np.isfinite(a["param_checksum"]) and a["param_checksum"] > 0
    assert runs[0][name][0]["losses"] == runs[0][name][1]["losses"]


@pytest.mark.parametrize("name", ["state", "align"])
def test_hosts_match_the_single_process_global_batch(runs, name):
    losses, single = runs[0][name][0]["losses"], runs[1][name]["losses"]
    assert len(losses) == len(single)
    np.testing.assert_allclose(losses[0], single[0], rtol=1e-5)
    np.testing.assert_allclose(losses[-1], single[-1], rtol=1e-4)
    assert runs[0][name][0]["summary"]["final_step"] == runs[1][name]["final_step"]


def test_first_loss_equals_the_jax_stage_loss(runs):
    cfg, dcfg = tiny_system().audio_llm, tiny_system().tts.decoder
    trainable, frozen = ttrain.build_trees("state", cfg, dcfg, 7, "cpu", 16)
    jsys = jtiny()
    batch = next(tdata.stage_batches("state", cfg, dcfg, 8, 1, seed=7))
    want = float(jts.stage_loss(
        "state", weights.to_numpy(trainable), weights.to_numpy(frozen),
        jsys.audio_llm, jsys.tts.decoder,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    np.testing.assert_allclose(runs[0]["state"][0]["losses"][0], want, rtol=1e-5)


def test_uneven_masks_take_the_global_mean(runs):
    """The align batch's halves hold different mask counts; the hosts'
    loss is the global mean, which the mean of per-host means misses."""
    cfg, dcfg = tiny_system().audio_llm, tiny_system().tts.decoder
    batch = next(tmani.manifest_batches("align", runs[2], ByteTokenizer(
        cfg.llm.vocab_size), cfg, 4, epochs=1, seed=3))
    halves = [{k: v[h * 2:(h + 1) * 2] for k, v in batch.items()} for h in (0, 1)]
    counts = [int(h["text_mask"].sum()) for h in halves]
    assert counts[0] != counts[1], counts
    trainable, frozen = ttrain.build_trees("align", cfg, dcfg, 3, "cpu", 16)
    denoms = tts.loss_denominators("align", batch)
    assert denoms == {"mask": float(sum(counts))}
    with torch.no_grad():
        local = [float(tts.stage_loss("align", trainable, frozen, cfg, dcfg,
                                      tts.to_tensors(h, "cpu"))) for h in halves]
        parts = [float(tts.stage_loss("align", trainable, frozen, cfg, dcfg,
                                      tts.to_tensors(h, "cpu"), denoms))
                 for h in halves]
    first = runs[0]["align"][0]["losses"][0]
    np.testing.assert_allclose(sum(parts), first, rtol=1e-5)
    np.testing.assert_allclose(runs[1]["align"]["losses"][0], first, rtol=1e-5)
    # the mean of per-host means misses by ten times the tolerance the
    # hosts are held to
    assert abs(np.mean(local) - first) > 10 * 1e-5 * abs(first)


def test_resume_on_both_hosts_continues_the_uninterrupted_run(runs):
    full = runs[0]["state"][0]["losses"]
    for r in runs[0]["resume"]:
        assert r["summary"]["final_step"] == 3
        np.testing.assert_allclose(r["losses"], full[2:], rtol=1e-5)
    assert runs[0]["resume"][0]["summary"]["param_checksum"] == \
        runs[0]["state"][0]["summary"]["param_checksum"]


def test_multi_host_batch_must_divide_over_the_hosts():
    with pytest.raises(SystemExit, match="multi-host requires --batch divisible "
                                         "by the global device count 2, got 3"):
        ttrain.main(with_flag(STATE, "--batch", "3") + [
            "--coordinator", "127.0.0.1:1", "--num_hosts", "2"])


@pytest.mark.parametrize("env", [False, True])
def test_a_coordinator_needs_two_hosts(monkeypatch, env):
    argv = STATE
    if env:
        monkeypatch.setenv("FO_COORDINATOR", "127.0.0.1:1")
    else:
        argv = STATE + ["--coordinator", "127.0.0.1:1"]
    with pytest.raises(ValueError, match="--num_hosts < 2"):
        ttrain.main(argv)


class _Joined(Exception):
    """Raised by the stand-in for multihost.join_local_ranks, before any
    process starts or any process group forms."""


@pytest.mark.parametrize("entry,batch,spreads", [
    ("main", 4, True),     # the CLI: a process a card, --batch divides
    ("main", 3, False),    # the CLI: not divisible, one process (JAX's message)
    ("run", 4, False),     # run(): one process whatever the cards
])
def test_only_the_cli_spreads_over_a_hosts_cards(monkeypatch, capsys, entry,
                                                  batch, spreads):
    """On a host with two cards (torch.cuda stands in for them), only the
    CLI's main joins a job of a process a card, through
    multihost.join_local_ranks with its own command line; run() trains in
    the one process it was called in, so a caller's `system=` reaches every
    rank there is."""
    from freeze_omni_tpu_torch.parallel import multihost as mh

    calls = []

    def join_local_ranks(*a):
        calls.append(a)
        raise _Joined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mh, "join_local_ranks", join_local_ranks)
    argv = ["--preset", "tiny", "--stage", "state", "--batch", str(batch)]
    if spreads:
        with pytest.raises(_Joined):
            ttrain.main(argv)
        assert calls == [("freeze_omni_tpu_torch.bin.train", argv, 2,
                          "FO_TRAIN_RANK", None, None, 1, 0)]
        return
    job = ttrain.join_job(ttrain.get_args(argv), local_ranks=entry == "main")
    assert not calls and job.group is None and job.world == 1
    said = "2 devices but batch 3 not divisible; running single-device"
    assert (said in capsys.readouterr().out) == (entry == "main")
