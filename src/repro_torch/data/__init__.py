"""Dataset helpers the models need."""
