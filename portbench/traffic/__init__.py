"""Traffic mixes (``<mix>.json``) and the generators that read them."""
