"""The quality run of the PyTorch port (`scripts/eval_quality.py`'s
configuration, gate and JSON keys, on CUDA); see
`dimo_tpu_torch/eval_quality.py`."""
from dimo_tpu_torch.eval_quality import main

if __name__ == "__main__":
    main()
