"""Device choice and the metrics subset the serving path uses."""
