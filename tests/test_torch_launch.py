"""The port's launcher (``repro_torch.launch.train``): its three
subcommands on the CPU at small sizes.  ``simulate`` prints what the
reference's prints on the same arguments, line for line; ``serve`` one
row per request; ``train --impl torch`` (the mirror of the reference's
"xla") a finite final loss.  ``train`` and ``serve`` default to the GPU;
the runs here pass ``--device cpu``."""
import argparse
import math
import re

import pytest

from repro.launch import train as ref_launch

from repro_torch.launch.train import main


def test_simulate_prints_the_reference_lines(capsys):
    out = main(["simulate", "--jobs", "40", "--chips", "32"])
    got = capsys.readouterr().out
    ref_launch.cmd_simulate(argparse.Namespace(system="all", chips=32,
                                               jobs=40, seed=0))
    want = capsys.readouterr().out
    assert got == want
    assert "vs mLoRA:" in got and len(out) == 5


def test_simulate_one_system(capsys):
    out = main(["simulate", "--system", "tlora", "--jobs", "20", "--chips",
                "16", "--seed", "3"])
    got = capsys.readouterr().out
    ref_launch.cmd_simulate(argparse.Namespace(system="tlora", chips=16,
                                               jobs=20, seed=3))
    assert got == capsys.readouterr().out
    assert list(out) == ["tlora"] and "vs mLoRA" not in got


@pytest.mark.parametrize("argv", [
    ["simulate", "--device", "cpu"], ["simulate", "--hw", "h100"],
    ["train", "--impl", "xla"], ["serve", "--impl", "pallas"]])
def test_launcher_refuses_what_it_does_not_take(argv, capsys):
    """``simulate`` takes only the reference's flags; the impls are the
    port's names ("torch" for "xla", "cuda" for "pallas")."""
    with pytest.raises(SystemExit):
        main(argv)
    capsys.readouterr()


def test_serve_prints_one_row_per_request(capsys):
    rows = main(["serve", "--device", "cpu", "--reduced", "--impl", "ref",
                 "--block-t", "8", "--requests", "4", "--tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "generated 4 rows:"
    assert len(lines) == 5 and len(rows) == 4
    for i, (line, row) in enumerate(zip(lines[1:], rows)):
        assert line == f"  req {i} [adapter-{i}] {row.tolist()}"
        assert len(row) == 3


def test_train_impl_torch_prints_a_finite_loss(capsys):
    out = main(["train", "--impl", "torch", "--device", "cpu", "--reduced",
                "--jobs", "2", "--steps", "2", "--seq-len", "32",
                "--batch-size", "1", "--block-t", "8", "--no-aimd"])
    text = capsys.readouterr().out
    loss = float(re.search(r"final loss (\S+)", text).group(1))
    assert math.isfinite(loss)
    assert out["ssm"].impl == "torch"
    assert out["report"].nano_history == [1, 1]
