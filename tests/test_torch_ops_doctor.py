"""The port's cli.doctor on the CPU: with --device cpu it runs every check
it can, green, and says that the CUDA kernels were not checked (the
probes of JAX's test_doctor_cli); without a card and without --device cpu
it fails."""
import pytest
import torch

from multimodalfusion_tpu.cli.doctor import main as jax_doctor
from multimodalfusion_tpu_torch.cli.doctor import main as port_doctor


def test_doctor_cpu_passes_the_jax_probes(capsys):
    assert jax_doctor([]) == 0
    jax_out = capsys.readouterr().out
    assert port_doctor(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "doctor: ok" in out and "doctor: ok" in jax_out
    assert "[fail]" not in out
    for probe in ("NIfTI write/read", "DICOM write/read", "fused pooling"):
        assert probe in out and probe in jax_out, probe
    assert "platform: torch" in out
    assert "native: csrc/bagio.cpp built" in out
    assert "the CUDA kernels were not checked (--device cpu)" in out
    for lib in ("tensorboardX", "orbax", "scikit-learn", "pandas"):
        assert f"optional: {lib} not needed" in out, lib


def test_doctor_without_a_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_doctor(["--full"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("[fail] platform:")
    assert "--device cpu" in out and "doctor: FAIL" in out
