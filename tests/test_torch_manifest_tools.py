"""The port's manifest-tool subcommands against the JAX tool's on one tiny
corpus (tests/fixtures.py: make_corpus, plus a video/ + text/ layout for
``generate``): the text outputs byte for byte, the generated mels within
1e-5, the babble wav and the mouth ROIs exactly."""
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch_parity  # noqa: F401 (one torch thread)

from multimodalvc_tpu.cli import manifest_tools as jtools
from multimodalvc_tpu_torch.cli import manifest_tools as ttools
from tests.fixtures import make_corpus

MEL_TOL = 1e-5


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two copies of one corpus (generate-mels writes beside the wavs), a
    video/ + text/ layout, a language table and a clip with landmarks."""
    base = tmp_path_factory.mktemp("mtools_port")
    for side in ("jax", "port"):  # the same corpus from the same seed
        make_corpus(str(base / side))
    layout = base / "layout"
    (layout / "video").mkdir(parents=True)
    (layout / "text").mkdir()
    rng = np.random.default_rng(0)
    from scipy.io import wavfile

    for i in range(3):
        np.save(layout / "video" / f"c{i}.npy", rng.integers(0, 255, (20, 32, 32), np.uint8))
        wav = (rng.standard_normal(12800 + 160 * i) * 0.05).astype(np.float32)
        wavfile.write(layout / "video" / f"c{i}.wav", 16000, (wav * 32767).astype(np.int16))
        (layout / "text" / f"c{i}.txt").write_text(f"Hallo Welt {i}")
    (base / "meta.csv").write_text("id,language\nclip0,de\nclip2,de\nclip1,en\nclip4,de\n")
    # a face clip: a bright mouth square and the default mean face's
    # landmarks, one detection missing
    from multimodalvc_tpu_torch.data.roi import default_mean_face

    lms = (default_mean_face(256) * 0.5 + 16.0).astype(np.float32)
    frames = np.zeros((5, 160, 160), np.float32)
    mx, my = (int(v) for v in lms[48:68].mean(axis=0))
    frames[:, my - 6:my + 6, mx - 6:mx + 6] = 1.0
    stack = np.stack([lms + 0.5 * i for i in range(5)])
    stack[2] = np.nan
    np.save(base / "clip.npy", frames)
    np.save(base / "lm.npy", stack)
    return base


def _argv(cmd, root, base, out):
    """The subcommand's arguments on corpus ``root``, writing under ``out``."""
    tsv = f"{root}/train.tsv"
    return {
        "generate": ["generate", "--root", str(base / "layout"), "--video-dir", "video",
                     "--text-dir", "text", "--out-tsv", f"{out}/all.tsv", "--workers", "2"],
        "split": ["split", "--tsv", tsv, "--out-dir", str(out), "--valid-frac", "0.2",
                  "--test-frac", "0.2", "--seed", "3"],
        "hours": ["hours", "--tsv", tsv],
        "normalize-rates": ["normalize-rates", "--tsv", tsv, "--out", f"{out}/norm.tsv"],
        "update-paths": ["update-paths", "--tsv", tsv, "--old", "data/", "--new", "DATA/",
                         "--out", f"{out}/upd.tsv"],
        "generate-mels": ["generate-mels", "--tsv", tsv, "--workers", "1"],
        "make-babble": ["make-babble", "--tsv", tsv, "--n", "4", "--seed", "2",
                        "--out", f"{out}/babble.wav"],
        "filter-language": ["filter-language", "--tsv", tsv, "--wrd", f"{root}/train.wrd",
                            "--meta", str(base / "meta.csv"), "--out", f"{out}/de.tsv"],
        "align-mouth": ["align-mouth", "--video", str(base / "clip.npy"), "--landmarks",
                        str(base / "lm.npy"), "--crop", "48", "--out", f"{out}/roi.npy"],
    }[cmd]


def _run_jax(argv, capsys):
    with mock.patch.object(sys, "argv", ["manifest_tools", *argv]):
        jtools.main()
    return capsys.readouterr().out


def _files(out):
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


SUBCOMMANDS = ["generate", "split", "hours", "normalize-rates", "update-paths", "generate-mels",
               "make-babble", "filter-language", "align-mouth"]


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_subcommand_matches_jax(corpora, cmd, capsys):
    outs = {}
    for side in ("jax", "port"):
        out = corpora / f"out_{cmd}_{side}"
        out.mkdir()
        # one corpus for both, but generate-mels, which writes into it
        argv = _argv(cmd, corpora / (side if cmd == "generate-mels" else "jax"), corpora, out)
        if side == "jax":
            printed = _run_jax(argv, capsys)
        else:
            ttools.main(argv)
            printed = capsys.readouterr().out
        outs[side] = (out, printed.replace(str(corpora / side), "ROOT").replace(str(out), "OUT"))
    (jout, jprint), (tout, tprint) = outs["jax"], outs["port"]
    assert tprint == jprint
    if cmd == "generate-mels":
        names = sorted(f for f in os.listdir(corpora / "jax" / "data") if f.endswith("bands.npy"))
        assert len(names) == 6
        for name in names:
            want = np.load(corpora / "jax" / "data" / name)
            got = np.load(corpora / "port" / "data" / name)
            assert got.shape == want.shape and got.shape[1] == 128
            np.testing.assert_allclose(got, want, rtol=MEL_TOL, atol=MEL_TOL)
        # present targets are kept without --overwrite
        ttools.main(_argv(cmd, corpora / "port", corpora, tout))
        assert "wrote 0/6" in capsys.readouterr().out
        return
    if cmd == "hours":
        assert "total hours" in tprint
    files = _files(tout)
    assert files == _files(jout) and (files or cmd == "hours")
    if cmd == "align-mouth":
        assert np.load(tout / "roi.npy").shape == (5, 48, 48)
