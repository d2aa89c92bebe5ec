"""Test-mode CLI of the PyTorch port (`main_test_dimo.py`'s keys, on CUDA)."""
from dimo_tpu_torch.cli import test_main

if __name__ == "__main__":
    test_main()
