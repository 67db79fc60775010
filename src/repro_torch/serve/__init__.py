from repro_torch.serve.engine import Request, ServingEngine
