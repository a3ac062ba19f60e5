"""The port's serve CLI against the reference's: the same flags parse to the
same values (``--numerics exact|interp``, default the config's own; 8
requests of 12 new tokens), and a run with no ``--numerics`` serves the
config's numerics."""
from __future__ import annotations

import argparse
import json

import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import serve as tserve

SHARED = ("arch", "smoke", "requests", "slots", "prompt_len", "max_new",
          "cache_len", "horizon", "numerics", "library", "save_library",
          "seed")


class _Parsed(Exception):
    pass


@pytest.fixture(scope="module")
def reference_parser():
    """The reference launcher's parser, caught as its ``main()`` parses."""
    from repro.launch import serve as jserve

    caught = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, *args, **kwargs):
        caught["ap"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(_Parsed):
            jserve.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["ap"]


@pytest.mark.parametrize("extra", [[], ["--numerics", "exact"],
                                   ["--numerics", "interp"],
                                   ["--requests", "3", "--max-new", "5"]])
def test_same_argv_same_values(extra, reference_parser):
    argv = ["--arch", "yi_6b", "--smoke", *extra]
    got = vars(tserve.build_parser().parse_args(argv))
    want = vars(reference_parser.parse_args(argv))
    assert {k: got[k] for k in SHARED} == {k: want[k] for k in SHARED}


def test_interp_fused_is_an_extra_name():
    args = tserve.build_parser().parse_args(
        ["--arch", "yi_6b", "--numerics", "interp-fused"])
    assert args.numerics == "interp-fused"


@pytest.mark.parametrize("numerics", [None, "interp"])
def test_cli_serves_the_config_numerics_by_default(numerics, capsys):
    """No ``--numerics``: the smoke config's exact numerics (no library);
    ``--numerics interp``: the default library through the plain versions
    on the CPU."""
    argv = ["--arch", "yi_6b", "--smoke", "--device", "cpu", "--requests",
            "2", "--max-new", "2"]
    if numerics:
        argv += ["--numerics", numerics]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tserve.main(argv)
    finally:
        torch.set_num_threads(n)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = numerics or get_smoke_config("yi_6b").numerics
    assert want == ("interp" if numerics else "exact")
    assert report["numerics"] == want and report["tokens"] == 4
    assert (report["rom_sha"] is None) == (want == "exact")
    assert set(report["stats"]["launches"].values()) == {0}
