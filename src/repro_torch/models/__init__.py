"""The port's models: layer graphs the planner prices, the paper's CNNs
(MobileNet-V2, ResNet50) for split execution, and the dense LM."""
