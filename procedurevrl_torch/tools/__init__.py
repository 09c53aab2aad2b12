"""The port's entry points: ``run_net`` (CLI), ``train_net``, ``test_net``,
``emb_extract``, ``feat_extract`` and ``dryrun``."""
