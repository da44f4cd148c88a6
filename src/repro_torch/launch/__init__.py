"""Entry points (``serve``, ``quickstart``) and the card's cost model
(``roofline``)."""
