"""Training: the loss, the train state and step, and the host loop."""
