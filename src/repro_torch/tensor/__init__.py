"""MLtoDNN: pipelines and tree ensembles compiled to tensor programs."""
