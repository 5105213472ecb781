"""Experiment configurations: the paper's DSO problems
(``dso_problems``) and the ten LM architectures with their registry
(``registry``), copies of the reference's."""
