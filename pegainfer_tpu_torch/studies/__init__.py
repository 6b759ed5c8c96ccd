"""H100 counterparts of the JAX package's TPU study scripts, run as
``python -m pegainfer_tpu_torch.studies.<name>`` (on the card unless
``--cpu`` is given)."""
