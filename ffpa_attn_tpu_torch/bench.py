"""``python -m ffpa_attn_tpu_torch.bench`` entry: the kernel cases against
torch SDPA, or the end-to-end legs with ``--e2e``."""

from .cli._bench import main

if __name__ == "__main__":
    raise SystemExit(main())
