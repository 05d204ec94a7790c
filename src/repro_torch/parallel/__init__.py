"""parallel substrate, as the JAX package's ``repro.parallel``: the
sharding rule table (``sharding``: parameter, batch and cache specs, and
their DTensor placements), activation sharding (``autoshard``) and int8
gradient compression (``compress``)."""
