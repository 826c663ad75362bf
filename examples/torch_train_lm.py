"""End-to-end driver on the PyTorch/CUDA port: train a small LM for a few
hundred steps (examples/train_lm.py, on repro_torch).

Any of the 10 assigned architectures is selectable (reduced config); the
loss must fall. Uses the same train step / checkpoint stack as the
port's launcher (repro_torch.launch.train).

The checkpoints go to a fresh temporary directory, removed at the end.
The JAX example writes to a fixed /tmp/repro_ckpt: a second run there
restores step 200 and then has no step left to train, and two runs at
once share the directory.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--arch
     mixtral-8x7b] [--steps 200] [--device cpu]
(the card by default; no fallback to the CPU).
"""
import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--steps" not in argv:
        argv += ["--steps", "200"]
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt:
        sys.exit(main(argv + ["--smoke", "--batch", "4", "--seq", "64",
                              "--ckpt-dir", ckpt]))
