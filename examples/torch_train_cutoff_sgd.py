"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM with
cutoff SGD, on one process or across data-parallel ranks.

The port of ``examples/train_cutoff_sgd.py``, with its options
(``--steps``, ``--seq``, ``--batch``, ``--workers``, ``--ckpt``,
``--method cutoff|sync``, ``--mask-agg``, ``--obs-dir``) and ``--device``.
On the card:

  PYTHONPATH=src python examples/torch_train_cutoff_sgd.py --steps 300
  PYTHONPATH=src torchrun --nproc-per-node 1 examples/torch_train_cutoff_sgd.py

On the CPU, two gloo ranks of two workers each:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      examples/torch_train_cutoff_sgd.py --device cpu --steps 4 --seq 16 \\
      --batch 8 --workers 4

See ``repro_torch.launch.cutoff_sgd``.
"""
import sys

from repro_torch.launch.cutoff_sgd import main

if __name__ == "__main__":
    sys.exit(main())
