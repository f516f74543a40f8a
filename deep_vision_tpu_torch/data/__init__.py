"""Input data: dvrec records, loaders, host transforms, device prefetch."""
