"""The mesh the models shard against (``ctx``) and the placements of
every parameter, batch, cache and optimizer tree (``sharding``)."""
