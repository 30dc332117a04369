"""tools/check_gpu: without a CUDA device it prints why and exits 1, and
runs nothing (no CPU path); on the card (`cuda`-marked, skips elsewhere)
the program exits 0 and prints its exact matmul line. The file imports no
jax: on the GPU machine it runs with
`python -m pytest --noconftest -m cuda tests/test_torch_check_gpu.py`."""
import os
import subprocess
import sys

import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch.tools import check_gpu


def test_check_gpu_refuses_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert check_gpu.main([]) == 1
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err
    assert "matmul" not in captured.out and "world" not in captured.out


@pytest.mark.cuda
def test_check_gpu_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m",
         "rgbx_semantic_segmentation_tpu_torch.tools.check_gpu"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"sum={check_gpu.N ** 3} == {check_gpu.N}^3" in proc.stdout
