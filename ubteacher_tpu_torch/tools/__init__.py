"""Command-line tools of the PyTorch port: the learning check
(`learning_sanity`) and the measuring tools (`mfu`, `profile_step`,
`ab_stem`) beside the one-command eval of a reference checkpoint
(`parity_eval`). Each runs on the first card unless `--cpu` is given, and
stops when there is none: `python -m ubteacher_tpu_torch.tools.<name> -h`.
"""
