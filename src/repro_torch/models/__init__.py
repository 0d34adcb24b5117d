"""Model substrate (serving paths): the dense LM (``transformer``, with
``attention`` and ``layers``) and the FM recommender (``recsys``)."""
