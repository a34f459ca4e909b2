"""The port's Config against the JAX package's: the example J1644-4559
configuration file and CLI overrides parse to identical fields."""

import dataclasses
import json
from pathlib import Path

import pytest

from srtb_tpu_torch.config import Config
from test_torch_ref import run_reference

CFG = str(Path(__file__).resolve().parents[1] / "examples"
          / "srtb_config_1644-4559.cfg")

ARGVS = {
    "defaults": ["--config_file_name", "/nonexistent/srtb_config.cfg"],
    "example_cfg": ["--config_file_name", CFG],
    "cfg_and_cli": ["--config_file_name", CFG, "--dm", " -400.5",
                    "--spectrum_channel_count", "2 ** 12",
                    "--mitigate_rfi_freq_list", "1410-1412, 1430-1431",
                    "--use_pallas", "0", "--dm_list", "1, 2.5",
                    "--udp_receiver_port", "1,2", "--fused_tail=off",
                    "--baseband_sample_rate", "64 * 1e6"],
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": name, "fn": "test_torch_ref:config_fields",
             "args": [argv]} for name, argv in ARGVS.items()]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_config"))


def _fields(cfg) -> dict:
    # through JSON, as the reference's fields arrive
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_fields_match_reference(ref, name):
    """Every field, exact: the same defaults, expression evaluation,
    list splitting and CLI-over-file precedence."""
    want = json.loads(str(ref[f"{name}/json"]))
    got = _fields(Config.from_args(list(ARGVS[name])))
    assert sorted(got) == sorted(want)
    assert got == want


def test_from_reference_fields_round_trip(ref):
    want = json.loads(str(ref["cfg_and_cli/json"]))
    cfg = Config.from_reference_fields(want)
    assert _fields(cfg) == want
    assert cfg.dm == -400.5 and cfg.spectrum_channel_count == 4096


def test_from_reference_fields_rejects_unknown_field():
    with pytest.raises(ValueError, match="not_a_field"):
        Config.from_reference_fields({"not_a_field": 1})
