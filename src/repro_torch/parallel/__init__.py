"""parallel substrate: what of the JAX package's ``repro.parallel`` runs
without a device mesh — ``compress`` (int8 gradient compression with
error feedback).  The sharding rules, the automatic sharder and the
compressed collective need a mesh: ROADMAP.md §1 item 4."""
