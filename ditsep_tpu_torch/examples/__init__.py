"""Learning loops of the port (examples/ of the repository, ported): a
small DiffSep trained from scratch on synthetic mixtures and the sampler
study on its checkpoint."""
