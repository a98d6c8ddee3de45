"""CLI tools of the port: the benchmark (``python -m ffpa_attn_tpu_torch.bench``),
its end-to-end legs (``--e2e``) and the headline line
(``python -m ffpa_attn_tpu_torch.cli._headline``)."""
