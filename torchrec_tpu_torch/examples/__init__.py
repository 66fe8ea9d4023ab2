"""The port's entry points: `python -m torchrec_tpu_torch.examples.dlrm_main`,
`dlrm_predict` and `bert4rec_main` (counterparts of examples/).
"""
