"""``python -m deft_tpu_torch.train``: ``train/run.py``'s ``main``."""

from deft_tpu_torch.train.run import main

if __name__ == "__main__":
    main()
