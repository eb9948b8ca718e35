"""Training from image files on the card: ``chip_smoke.py``'s phase 20
(``ImageBatchIter`` -> ``DevicePrefetcher`` on a side CUDA stream ->
graphed ResNet-50 b32 through K1-multi) with its four gates: pipeline-fed
training bitwise with directly fed training, a bitwise resume, a forked
worker's batches equal to the thread worker's, and the batch copies on a
stream other than the step's, from pinned memory.

Marked ``cuda``: it skips with a reason where ``torch.cuda.is_available()``
is false. It imports only torch, the port and ``chip_smoke.py``, so it runs
on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_data.py -m cuda -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the phase runs in a process of its own: in one process with it and the
# other card tests, test_torch_cuda_kernels.py's profiler sessions saw no
# device event (they pass alone and right after the phase)
PHASE = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
from singa_tpu_torch import cuda_build, device
cuda_build.build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
out = chip_smoke.image_files_phase(device.create_cuda_gpu(0))
print(json.dumps({{k: out[k] for k in ("states_held",
                  "resumed_batches_held", "process_batches_held",
                  "traced")}}))
"""


@pytest.mark.cuda
def test_image_files_phase_holds_its_gates():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    proc = subprocess.run([sys.executable, "-c", PHASE.format(root=ROOT)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["states_held"] > 0
    assert out["resumed_batches_held"] == \
        chip_smoke.IMAGE_STEPS - chip_smoke.IMAGE_RESUME_AT
    assert out["process_batches_held"] == \
        chip_smoke.IMAGE_FILES // chip_smoke.BATCH
    assert out["traced"]["sgd_multi_per_replay"] == 2
    assert out["traced"]["step_stream"] not in out["traced"]["copy_streams"]
