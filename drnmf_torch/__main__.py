"""``python -m drnmf_torch`` is ``python -m drnmf_torch.cli``."""

from .cli import main

if __name__ == "__main__":
    main()
