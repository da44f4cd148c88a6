"""Entry points (``serve``, ``quickstart``, ``train``, ``train_pipeline``),
meshes and worlds of ranks (``mesh``), and the card's cost model
(``roofline``)."""
