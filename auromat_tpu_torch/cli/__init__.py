"""Console tools of the port: ``python -m auromat_tpu_torch.cli.convert``."""
