"""Dense model layers, the decode steps and the operator-segmented prefill."""
