"""The command line: ``python -m scmgan_tpu_torch --env ... [flags]``."""
