"""`python -m regione_tpu_torch.bench`: the headline (`bench.headline`)."""

from regione_tpu_torch.bench.headline import main

if __name__ == "__main__":
    main()
