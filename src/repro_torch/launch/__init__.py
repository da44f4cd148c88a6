"""Entry points (``serve``, ``quickstart``, ``train``, ``train_pipeline``)
and the card's cost model (``roofline``)."""
