"""Traffic mixes: parameter files and the generator that reads them."""
