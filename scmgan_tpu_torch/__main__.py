"""``python -m scmgan_tpu_torch --env <name> [flags]``: the port's main.py."""

from scmgan_tpu_torch.cli.main import main

if __name__ == "__main__":
    main()
