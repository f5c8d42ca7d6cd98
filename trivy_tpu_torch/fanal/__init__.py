"""Artifact analysis on the host: image archives and filesystem trees
(`artifact`), the layer and tree walkers, the analyzers, the
post-handlers, the blob cache and the layer squash (`applier`)."""
