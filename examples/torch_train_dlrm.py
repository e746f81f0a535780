"""End-to-end training example on the PyTorch port: a ~100M-parameter DLRM
(dlrm-100m) for a few hundred steps with the production optimizer mix
(rowwise Adagrad on the tables, Adam elsewhere), prefetching pipeline, async
checkpointing and restart.  On the GPU the step's backward runs the
hand-written kernels K1' (the table's gradient) and K2' (the dot
interaction's).

  PYTHONPATH=src python examples/torch_train_dlrm.py --steps 200 --ckpt-dir /tmp/dlrm_ck
  PYTHONPATH=src python examples/torch_train_dlrm.py --device cpu --steps 20 --batch 32
  # kill it mid-run, then rerun with --resume: it continues from the last save
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
