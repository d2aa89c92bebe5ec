"""Training CLI of the PyTorch port (`main_train_dimo.py`'s keys, on CUDA)."""
from dimo_tpu_torch.cli import train_main

if __name__ == "__main__":
    train_main()
