from repro_torch.analysis.runner import main

if __name__ == "__main__":
    raise SystemExit(main())
